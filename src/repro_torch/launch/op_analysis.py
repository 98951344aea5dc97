"""Op-level analysis of an eager step: FLOPs, an HBM-traffic proxy, the
peak of live tensor bytes and the SW attention's score-tensor bytes.

The port's counterpart of the reference's ``launch/hlo_analysis.py``.
There is no compiled program text to parse: the step runs eagerly, on
``torch.device("meta")`` in the dry run, under a ``TorchDispatchMode``
that sees every aten op the step and its autograd backward dispatch.
Loops are Python loops, so every iteration's ops are seen and trip counts
need no parsing.  Per op:

  * FLOPs of the dot-like ops (mm, addmm, bmm, baddbmm, convolutions, the
    sdpa family), from ``torch.utils.flop_counter``'s formulas, which
    count a dot as ``hlo_analysis`` does: 2 * out_elems * contracted size;
  * HBM-traffic proxy: each op's result written and read (2x), as
    ``hlo_analysis`` counts a fusion's root; a view (an op whose schema
    aliases its result to an input) materialises nothing and counts 0; an
    in-place op counts its result.  The caller adds the params, read once
    (``OpAnalysis.read_once``).  Eager PyTorch fuses nothing, so every op's
    result counts, where XLA would keep a fusion's inner values on chip;
  * live bytes: each storage an op creates is held until its last tensor
    dies (a weak reference to the storage), so ``peak_bytes`` is the peak
    of what is alive, not an analytic sum.  Sizes are rounded up to
    ``ALIGN`` bytes, the CUDA caching allocator's block size, so the peak
    reads like ``torch.cuda.max_memory_allocated``;
  * score bytes: the score tensors of ``kernels/flash_attention/ref.py``'s
    ``attention_chunked``, 2x as above: inside it, the (..., Sq, C)
    results (C its KV chunk, Sq its query length, which it publishes
    through ``ref.score_geometry()``) of the QK product and
    of every elementwise op on a score (softcap, mask, exp, casts); the
    PV product, which reads a score, is not one, nor is the mask, which
    reads none, so a head dim equal to C does not confuse the two.  The
    HW route's kernel keeps these tiles in shared memory, so the HW-route
    projection subtracts them (``hlo_analysis.score_tensor_bytes``'s
    role).

Counting (FLOPs, traffic, scores) runs only inside ``counting()``; live
bytes are tracked for the mode's whole extent, so tensors made before
``counting()`` (params, optimiser state, caches) are part of the peak.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention import ref as _attn_ref

ALIGN = 512


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


@dataclass
class OpStats:
    """What ``counting()`` saw: FLOPs, traffic proxy bytes, score bytes
    (both 2x the results), and ops counted."""
    flops: float = 0.0
    bytes_hbm: float = 0.0
    score_bytes: float = 0.0
    n_ops: int = 0
    bytes_by_op: Dict[str, float] = field(default_factory=dict)

    def scaled_add(self, other: "OpStats", k: float = 1.0) -> "OpStats":
        """``self + k * other`` (a new record)."""
        by = dict(self.bytes_by_op)
        for name, b in other.bytes_by_op.items():
            by[name] = by.get(name, 0.0) + k * b
        return OpStats(self.flops + k * other.flops,
                       self.bytes_hbm + k * other.bytes_hbm,
                       self.score_bytes + k * other.score_bytes,
                       self.n_ops + int(k * other.n_ops), by)

    def top_ops(self, n: int = 16) -> List[Tuple[str, float]]:
        return sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as oa:`` tracks live bytes; ``with
    oa.counting() as st:`` counts into ``st`` (an ``OpStats``)."""

    def __init__(self):
        super().__init__()
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._scores: Set[int] = set()        # storages of score tensors
        self.live_bytes = 0
        self.peak_bytes = 0
        self._stats = None

    # ------------------------------------------------------------ live
    def _drop(self, key: int):
        entry = self._live.pop(key, None)
        self._scores.discard(key)
        if entry is not None:
            self.live_bytes -= entry[1]

    def hold(self, tree):
        """Track the storages of ``tree``'s tensors (made outside the
        mode)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = _aligned(st.nbytes())
        ref = weakref.ref(st, lambda _, k=key: self._drop(k))
        self._live[key] = (ref, n)
        self.live_bytes += n

    # -------------------------------------------------------- counting
    @contextlib.contextmanager
    def counting(self):
        st, prev = OpStats(), self._stats
        self._stats = st
        try:
            yield st
        finally:
            self._stats = prev

    def read_once(self, tree):
        """Add ``tree``'s bytes (params) to the counted traffic, read
        once."""
        n = sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor))
        st = self._stats
        st.bytes_hbm += n
        st.bytes_by_op["params (read once)"] = \
            st.bytes_by_op.get("params (read once)", 0.0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        st = self._stats
        if st is not None:
            st.n_ops += 1
            packet = func.overloadpacket
            if packet in flop_registry:
                st.flops += flop_registry[packet](*args, **kwargs,
                                                  out_val=out)
            if not func.is_view:
                nbytes = 2.0 * sum(t.numel() * t.element_size()
                                   for t in outs)
                if nbytes:
                    st.bytes_hbm += nbytes
                    name = packet.__name__
                    st.bytes_by_op[name] = st.bytes_by_op.get(name, 0.0) \
                        + nbytes
                    geom = _attn_ref.score_geometry()
                    if geom is not None:
                        st.score_bytes += self._score_bytes(
                            geom, packet in flop_registry, args, kwargs,
                            outs)
        return out

    def _score_bytes(self, geom, is_dot, args, kwargs, outs) -> float:
        Sq, C = geom
        shaped = [t for t in outs
                  if t.dim() >= 2 and t.shape[-1] == C and t.shape[-2] == Sq]
        if not shaped:
            return 0.0
        reads_score = any(
            id(t.untyped_storage()) in self._scores
            for t in tree_leaves((args, kwargs))
            if isinstance(t, torch.Tensor))
        if is_dot == reads_score:    # the PV product, or the mask
            return 0.0
        for t in shaped:
            self._scores.add(id(t.untyped_storage()))
        return 2.0 * sum(t.numel() * t.element_size() for t in shaped)

