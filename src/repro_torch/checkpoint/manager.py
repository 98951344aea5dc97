"""Checksummed checkpoints in the reference's on-disk format.

Port of the reference's ``checkpoint/manager.py``.  A checkpoint written
by either package restores in the other:

* layout: ``<dir>/step_<N:08d>/`` with one ``.npy`` per leaf and a
  ``manifest.json`` of ``{"step", "extra", "leaves": {key: {file, shape,
  dtype, checksum}}}``;
* leaf keys: the reference's ``_leaf_paths`` joins of
  ``jax.tree_util.tree_flatten_with_path`` — dict keys sorted, sequence
  indices, NamedTuple fields as ``.<name>`` (``opt/.mu/embed/table``);
* bf16 leaves are stored as their uint16 bit pattern with the logical
  dtype ``"bfloat16"`` in the manifest (no ``ml_dtypes``: torch views the
  bits);
* the checksum is the reference's ``_checksum_np``: the sum of the stored
  array's bytes mod 2^32.  The reference's docstring calls it the paper's
  Fig.-4 popcount; its code, kept here for format parity, sums bytes.

``save_async`` snapshots every leaf to host memory before it hands the
write to a one-worker pool, so the next step may overwrite the tensors in
place.  Writes go to a temporary directory renamed into place (atomic);
the newest ``keep`` checkpoints are kept.  ``restore`` places each leaf on
the device of ``like``'s leaf, or on the device the ``shardings`` tree
gives, and raises ``IOError`` on a checksum mismatch.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

PyTree = Any

# numpy has no bf16/fp8: those travel as same-width unsigned bit patterns
# with the logical dtype in the manifest (the reference's _EXOTIC)
_EXOTIC = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
           torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
           torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_BY_NAME = {name: (torch_dt, view) for torch_dt, (name, _, view)
            in _EXOTIC.items()}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(path entry, child) pairs in ``tree_flatten_with_path`` order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/.mu/c": leaf} in the reference's key dialect and order."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_leaf_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [_rebuild(v, fn, f"{prefix}/{k}" if prefix else k)
            for k, v in kids]
    return type(tree)(*vals) if _is_namedtuple(tree) else type(tree)(vals)


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(stored numpy array, logical dtype name) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)     # never the live storage
        if t.dtype in _EXOTIC:
            name, np_dt, view = _EXOTIC[t.dtype]
            return t.contiguous().view(view).numpy().view(np_dt), name
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    # (np.ascontiguousarray would make a 0-d leaf 1-d)
    return np.require(arr, requirements="C"), arr.dtype.name


def _to_tensor(arr: np.ndarray, logical: str, device) -> torch.Tensor:
    if logical in _BY_NAME:
        torch_dt, view = _BY_NAME[logical]
        np_view = np.int16 if view == torch.int16 else np.uint8
        t = torch.from_numpy(arr.view(np_view)).view(torch_dt)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _checksum_np(a: np.ndarray) -> int:
    """The reference's leaf checksum: the stored array's bytes summed mod
    2^32 (an int64 sum cannot overflow below 2^55 bytes)."""
    b = np.require(a, requirements="C").reshape(-1).view(np.uint8)
    if not b.flags.writeable:           # torch wraps writable arrays only
        return int(b.sum(dtype=np.uint64)) % (1 << 32)
    return int(torch.from_numpy(b).sum(dtype=torch.int64)) % (1 << 32)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: PyTree, *, extra: Optional[dict] = None):
        self._write(step, self._snapshot(tree), extra or {})

    def save_async(self, step: int, tree: PyTree,
                   *, extra: Optional[dict] = None):
        self.wait()
        host = self._snapshot(tree)
        self._pending = self._pool.submit(self._write, step, host,
                                          extra or {})

    @staticmethod
    def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
        return {k: _to_host(v) for k, v in _leaf_paths(tree).items()}

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, (stored, logical) in host.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), stored)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(stored.shape), "dtype": logical,
                "checksum": _checksum_np(stored)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self):
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: PyTree, *, shardings: PyTree = None,
                verify: bool = True) -> PyTree:
        """Restore into the structure of ``like``: each leaf on the device
        of ``like``'s leaf (a tensor), or on the device the ``shardings``
        tree gives for it (a tree of devices or None)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        placed = _leaf_paths(shardings) if shardings is not None else {}

        def leaf(key, x):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]))
            if verify and _checksum_np(arr) != meta["checksum"]:
                raise IOError(f"checkpoint corruption in leaf {key}")
            dev = placed.get(key)
            if dev is None:
                dev = x.device if isinstance(x, torch.Tensor) else "cpu"
            return _to_tensor(arr, meta["dtype"], dev)
        return _rebuild(like, leaf)

    def extra(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)["extra"]
