"""Hopper kernels of the port (the Oobleck "hardware" lowerings).

Each subpackage: ``kernel.py`` (the wrapper that launches the CUDA kernel
from ``csrc/`` on CUDA tensors, with its plain blocked version for CPU
tensors and a launch counter), ``ops.py`` (Viscosity registration) and
``ref.py`` (PyTorch oracles).
"""
