"""repro_torch: the PyTorch + CUDA port of the Oobleck reproduction.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (nor of JAX).  Each Viscosity op keeps two lowerings: the
HW lowering is a CUDA C++ kernel written by hand for Hopper (``csrc/``,
built by ``kernels/_build.py`` at first use), the SW lowering a plain
PyTorch oracle.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
