"""Carry the reference's state across: trees of numpy arrays -> tensors.

The caller turns the reference's pytree into numpy on its side
(``jax.tree_util.tree_map(np.asarray, params)``), so this module imports
no JAX.  Keys, nesting, shapes and dtypes stay as they are; bf16 leaves
(numpy's ``ml_dtypes`` bfloat16) travel as their uint16 bit pattern.
``params_from_jax`` carries params (NamedTuples keep their class),
``opt_state_from_jax`` the reference's ``AdamWState``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWState


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))        # a writable copy
    return t.to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on ``device`` (None -> ``cuda``)."""
    dev = resolve_device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):   # NamedTuple
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return _leaf(x, dev)
    return walk(tree)


def opt_state_from_jax(state: Any, device=None) -> AdamWState:
    """The reference's ``AdamWState`` (its leaves numpy) -> the port's, on
    ``device`` (None -> ``cuda``): ``count`` an int32 scalar tensor, the
    moments trees of f32 tensors."""
    return AdamWState(count=params_from_jax(state.count, device),
                      mu=params_from_jax(state.mu, device),
                      nu=params_from_jax(state.nu, device))
