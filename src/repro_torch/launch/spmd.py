"""The tensor-parallel runtime: what XLA's SPMD partitioner does for the
reference, carried out by hand on each rank.

``spmd(mesh, rules, axes, coords, comm)`` puts one rank's place in a
device mesh in force: its coordinates, one communicator over every
subset of mesh axes, the logical-axis rules (``sharding.axis_rules``)
and the param-axis assignment (``partition.DEFAULT_AXES`` or a
variant's).  The models then run on the rank's shards
(``partition.shard_tree``) and call four collectives, each a
``torch.autograd.Function`` whose backward is its conjugate, so a
sharded training step's gradients are the unsharded step's:

  * ``reduce_over(x, axis)``: all-reduce of a partial sum (run in f32,
    cast back); backward the identity.  Where a row-sharded product ends
    (``wo``, the MLP's ``w2``, a vocab-sharded embedding lookup).
  * ``replicate_over(x, axis)``: the identity; backward all-reduces the
    gradient.  Where a replicated tensor enters a computation sharded
    over ``axis`` (the input of column-sharded products, replicated K/V
    read by sharded heads, a replicated scale applied to sharded heads).
  * ``gather_over(x, axis, dim)``: all-gather along ``dim``; backward
    keeps the rank's slice (column-sharded logits before sampling).
  * ``scatter_over(x, axis, dim)``: keeps the rank's slice; backward
    all-gathers.

A tensor is thus replicated (the same on every rank of an axis, its
gradient the same too), sharded (a slice), or partial (a sum still owed).
A gathered or summed tensor that the rank's own shard then reads (B and
C under split Mamba2 heads, a norm's sum of squares over a cut width)
is replicated entering a sharded computation: ``replicate_over`` after
the gather or the reduce makes its gradient whole.  ``leaf_axis`` reads
a param's axis from its spec (``partition.param_pspec``), ``cache_axis``
a serving state's; ``sum_by_spec`` sums per-leaf values over each leaf's
cut axes (AdamW's global norm).
Outside ``spmd(...)``, or over an axis of one rank, each is the identity:
it returns its input itself, touches no tensor and adds no op, so every
path outside runs the ops it ran before.

Communicators:
  * ``GroupComm``: ``torch.distributed`` process groups over the ranks
    ``launch.distributed.initialize_runtime`` opened, one group per subset
    of mesh axes.  gloo (CPU, or ranks sharing one card, which NCCL
    refuses) carries copies on the host; NCCL, one card a rank
    (``mesh.rank_device``), the device tensors where they lie.
  * ``CountingComm``: the dry run's stub on the meta device; it returns
    the right shape and moves nothing.
Both record each collective's kind, axis, dtype and bytes
(``CollectiveLog``): the payload, and the per-device link bytes of a ring
(all-reduce 2(m-1)/m of the payload, all-gather (m-1)/m of its output,
reduce-scatter (m-1)/m of its input), as the reference's
``hlo_analysis`` counts them.  ``reduce_scatter`` is ZeRO-1's
(``launch/tp_train.py``); the models call the four above.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.launch import partition
from repro_torch.launch.sharding import (Axis, axis_rules, axis_size,
                                         mesh_sizes, resolve)

_state = threading.local()


# ------------------------------------------------------------ accounting
@dataclass
class CollectiveLog:
    """Per (kind, axis, dtype): calls, payload bytes and ring link bytes
    per device."""
    entries: Dict[Tuple[str, str, str], Dict[str, float]] = field(
        default_factory=dict)

    def add(self, kind: str, axis: Axis, dtype: torch.dtype, payload: int,
            m: int):
        link = (2.0 * payload * (m - 1) / m if kind == "all-reduce"
                else payload * (m - 1) / m)
        key = (kind, axis_name(axis), str(dtype).replace("torch.", ""))
        e = self.entries.setdefault(key, {"n": 0, "bytes": 0.0,
                                          "link_bytes": 0.0})
        e["n"] += 1
        e["bytes"] += payload
        e["link_bytes"] += link

    def by_kind(self, what: str = "link_bytes") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (kind, _, _), e in self.entries.items():
            out[kind] = out.get(kind, 0.0) + e[what]
        return out

    def by_axis(self, what: str = "link_bytes") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (_, ax, _), e in self.entries.items():
            out[ax] = out.get(ax, 0.0) + e[what]
        return out

    def copy(self) -> Dict[Tuple[str, str, str], Dict[str, float]]:
        return {k: dict(v) for k, v in self.entries.items()}

    def repeat_since(self, before, times: float):
        """Add ``times`` more of what was logged since ``before`` (a
        ``copy()``): the dry run runs one microbatch for several."""
        for key, e in self.copy().items():
            b = before.get(key, {"n": 0, "bytes": 0.0, "link_bytes": 0.0})
            cur = self.entries[key]
            for f in ("n", "bytes", "link_bytes"):
                cur[f] += times * (e[f] - b[f])

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {"|".join(k): dict(v) for k, v in sorted(self.entries.items())}

    def reset(self):
        self.entries.clear()


def axis_name(axis: Axis) -> str:
    return "+".join(axis) if isinstance(axis, tuple) else str(axis)


def _axes_tuple(axis: Axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


# ---------------------------------------------------------- communicators
class CountingComm:
    """The dry run's communicator: no data moves; each call returns a
    tensor of the collective's result shape (on meta, nothing is
    allocated) and is recorded in ``log``."""

    def __init__(self, mesh):
        self.sizes = mesh_sizes(mesh)
        self.log = CollectiveLog()

    def all_reduce(self, x, axis):
        self.log.add("all-reduce", axis, x.dtype,
                     x.numel() * x.element_size(), axis_size(self.sizes, axis))
        return x.clone()

    def all_gather(self, x, axis, dim):
        m = axis_size(self.sizes, axis)
        out = torch.cat([x] * m, dim=dim)
        self.log.add("all-gather", axis, x.dtype,
                     out.numel() * out.element_size(), m)
        return out

    def reduce_scatter(self, x, axis, dim):
        m = axis_size(self.sizes, axis)
        self.log.add("reduce-scatter", axis, x.dtype,
                     x.numel() * x.element_size(), m)
        return x.narrow(dim, 0, x.shape[dim] // m).clone()


class GroupComm:
    """``torch.distributed`` process groups over a mesh whose ranks are
    the global ranks in row-major mesh order: one group for every subset
    of mesh axes (every rank builds them all, in one order, as
    ``new_group`` requires; ``build_s`` is what that took, and under NCCL
    a group makes its communicator at its first collective).  ``host``
    moves each payload through a CPU copy (gloo's default: it also suits
    ranks that share one card); without it each collective runs on the
    tensors where they lie (NCCL's, on the rank's card).  ``timed``
    records each collective's time by kind (``times``): CUDA events on
    the current stream around it on the card, the host clock on the
    CPU."""

    def __init__(self, mesh, rank: int, *, host: Optional[bool] = None,
                 timed: bool = False):
        import torch.distributed as dist
        t0 = time.perf_counter()
        self.dist = dist
        self.sizes = mesh_sizes(mesh)
        names = list(self.sizes)
        coords = partition.mesh_coords(mesh)
        self.rank = rank
        self.coords = coords[rank]
        self.host = (dist.get_backend() == "gloo") if host is None else host
        self.log = CollectiveLog()
        self.timed = timed
        self._spans: List[Tuple[str, Any, Any]] = []
        self.groups: Dict[Tuple[str, ...], Any] = {}
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                rest = [a for a in names if a not in sub]
                for fixed in itertools.product(
                        *(range(self.sizes[a]) for a in rest)):
                    members = [r for r, c in enumerate(coords)
                               if all(c[a] == v for a, v in zip(rest, fixed))]
                    g = dist.new_group(members)
                    if rank in members:
                        self.groups[sub] = g
        self.build_s = time.perf_counter() - t0

    def _group(self, axis):
        return self.groups[tuple(a for a in self.sizes
                                 if a in _axes_tuple(axis))]

    @contextlib.contextmanager
    def _span(self, kind: str, x):
        if not self.timed:
            yield
            return
        if x.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            yield
            ev[1].record()
            self._spans.append((kind, *ev))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((kind, t0, time.perf_counter()))

    def times(self) -> Dict[str, Dict[str, float]]:
        """Each kind's collectives since the last call: {"n", "ms"} (the
        card synchronised first), and forget them."""
        out: Dict[str, Dict[str, float]] = {}
        for kind, a, b in self._spans:
            if isinstance(a, float):
                ms = 1e3 * (b - a)
            else:
                b.synchronize()
                ms = a.elapsed_time(b)
            e = out.setdefault(kind, {"n": 0, "ms": 0.0})
            e["n"] += 1
            e["ms"] += ms
        self._spans.clear()
        return out

    def all_reduce(self, x, axis):
        self.log.add("all-reduce", axis, x.dtype,
                     x.numel() * x.element_size(), axis_size(self.sizes, axis))
        with self._span("all-reduce", x):
            buf = x.detach().to("cpu", copy=True) if self.host else \
                x.detach().clone().contiguous()
            self.dist.all_reduce(buf, group=self._group(axis))
            out = buf.to(x.device)
        return out

    def all_gather(self, x, axis, dim):
        m = axis_size(self.sizes, axis)
        with self._span("all-gather", x):
            src = x.detach().to("cpu") if self.host else x.detach()
            src = src.contiguous()
            if self.host and src.element_size() == 2:
                src = src.view(torch.float16)   # gloo gathers the bits
            parts = [torch.empty_like(src) for _ in range(m)]
            self.dist.all_gather(parts, src, group=self._group(axis))
            out = torch.cat(parts, dim=dim).view(x.dtype).to(x.device)
        self.log.add("all-gather", axis, x.dtype,
                     out.numel() * out.element_size(), m)
        return out

    def reduce_scatter(self, x, axis, dim):
        """The sum over ``axis`` of ``x``, cut along ``dim``: the rank's
        1/m block (its index along ``axis``)."""
        m = axis_size(self.sizes, axis)
        self.log.add("reduce-scatter", axis, x.dtype,
                     x.numel() * x.element_size(), m)
        with self._span("reduce-scatter", x):
            src = x.detach().to("cpu") if self.host else x.detach()
            # the blocks along dim 0, each contiguous, as the collective
            # takes them
            src = src.movedim(dim, 0).contiguous()
            out = torch.empty((src.shape[0] // m,) + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            self.dist.reduce_scatter_tensor(out, src,
                                            group=self._group(axis))
            out = out.movedim(0, dim).contiguous().to(x.device)
        return out


# ---------------------------------------------------------------- context
@dataclass
class SpmdContext:
    """One rank's place in a mesh (see the module docstring)."""
    mesh: Any
    sizes: Dict[str, int]
    rules: Dict[str, Axis]
    axes: Dict[str, Axis]
    coords: Dict[str, int]
    comm: Any
    dims: Dict[str, int] = field(default_factory=dict)

    def size(self, axis: Axis) -> int:
        return axis_size(self.sizes, axis)

    def index(self, axis: Axis) -> int:
        return partition.axis_index(self.sizes, self.coords, axis)

    def param_axis(self, family: str, n: int) -> Axis:
        """The axis a param family's dim of global size ``n`` is sharded
        over (``partition.param_pspec``'s rule), None when replicated."""
        ax = self.axes.get(family)
        m = self.size(ax)
        return ax if m > 1 and n % m == 0 else None

    def rule_axis(self, name: str, n: int) -> Axis:
        """The axis the rules shard logical dim ``name`` (global size
        ``n``) over, None when it is replicated or does not divide."""
        ax = resolve(name)[0]
        m = self.size(ax)
        return ax if m > 1 and n % m == 0 else None

    def batch_axis(self) -> Axis:
        ax = resolve("batch")[0]
        return ax if self.size(ax) > 1 else None


def current() -> Optional[SpmdContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def spmd(mesh, rules: Mapping[str, Axis], axes: Optional[Mapping] = None,
         coords: Optional[Mapping[str, int]] = None, comm=None, *,
         dims: Optional[Mapping[str, int]] = None):
    """Run the body as the rank at ``coords`` of ``mesh`` (see the module
    docstring); ``dims`` are the global sizes of logical dims that
    ``constrain`` checks (``logical_sizes(cfg)``)."""
    ctx = SpmdContext(mesh=mesh, sizes=mesh_sizes(mesh), rules=dict(rules),
                      axes=dict(axes or partition.DEFAULT_AXES),
                      coords=dict(coords or {}),
                      comm=comm if comm is not None else CountingComm(mesh),
                      dims=dict(dims or {}))
    prev = current()
    _state.ctx = ctx
    try:
        with axis_rules(ctx.rules, mesh):
            yield ctx
    finally:
        _state.ctx = prev


def bound(fn):
    """``fn`` run under the context active now (and its axis rules)
    wherever it is called: a remat body that autograd recomputes in the
    backward, which on the card runs on a device thread where the
    thread-local context is not set.  ``fn`` itself outside ``spmd``."""
    c = current()
    if c is None:
        return fn

    def run(*args, **kwargs):
        if current() is c:
            return fn(*args, **kwargs)
        prev = current()
        _state.ctx = c
        try:
            with axis_rules(c.rules, c.mesh):
                return fn(*args, **kwargs)
        finally:
            _state.ctx = prev
    return run


def logical_sizes(cfg) -> Dict[str, int]:
    """The global sizes of a config's logical dims, for ``constrain``."""
    out = {"embed": cfg.d_model, "mlp": cfg.d_ff, "vocab": cfg.vocab_size,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim}
    if cfg.moe is not None:
        out["experts"] = cfg.moe.num_experts
    if cfg.ssm is not None and cfg.family == "hybrid":
        # Mamba2's xbc: x, B and C of every head
        out["ssm_inner"] = (cfg.ssm.expand * cfg.d_model
                            + 2 * cfg.ssm.state_dim)
    elif cfg.ssm is not None:
        out["ssm_heads"] = cfg.d_model // cfg.ssm.rwkv_head_dim
        out["head_dim"] = cfg.ssm.rwkv_head_dim
    return out


# ------------------------------------------------------------ collectives
def _active(axis: Axis) -> Optional[SpmdContext]:
    ctx = current()
    if ctx is None or axis is None or ctx.size(axis) == 1:
        return None
    return ctx


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axis):
        return c.comm.all_reduce(x.float(), axis).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# The backward functions keep the forward's context: autograd may run a
# backward on a device thread, where the thread-local one is not set.
class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axis):
        ctx.c, ctx.axis = c, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.c.comm.all_reduce(g.float(), ctx.axis).to(g.dtype), \
            None, None


def _slice(x, c: SpmdContext, axis, dim):
    n = x.shape[dim] // c.size(axis)
    return x.narrow(dim, c.index(axis) * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axis, dim):
        ctx.c, ctx.axis, ctx.dim = c, axis, dim
        return c.comm.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.c, ctx.axis, ctx.dim).contiguous(), \
            None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axis, dim):
        ctx.c, ctx.axis, ctx.dim = c, axis, dim
        return _slice(x, c, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.c.comm.all_gather(g.contiguous(), ctx.axis, ctx.dim), \
            None, None, None


def reduce_over(x, axis: Axis):
    """All-reduce of a partial sum over ``axis`` (f32, cast back)."""
    c = _active(axis)
    return x if c is None else _Reduce.apply(x, c, axis)


def replicate_over(x, axis: Axis):
    """A replicated ``x`` entering a computation sharded over ``axis``:
    the identity, whose backward all-reduces the gradient."""
    c = _active(axis)
    if c is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Replicate.apply(x, c, axis)


def gather_over(x, axis: Axis, dim: int):
    """All-gather of a tensor sharded over ``axis`` along ``dim``."""
    c = _active(axis)
    return x if c is None else _Gather.apply(x, c, axis, dim)


def scatter_over(x, axis: Axis, dim: int):
    """The rank's slice along ``dim`` of a tensor replicated over
    ``axis``."""
    c = _active(axis)
    return x if c is None else _Scatter.apply(x, c, axis, dim)


def _live(axis: Axis, c: SpmdContext) -> Axis:
    """``axis`` without its names of one rank (None when none is left)."""
    rest = tuple(a for a in _axes_tuple(axis) if c.size(a) > 1) \
        if axis is not None else ()
    return None if not rest else (rest[0] if len(rest) == 1 else rest)


def _tail(a: Axis, b: Axis):
    """The names of ``a`` after ``b``'s when ``b``'s names lead ``a``'s, so
    that a rank's block over ``a`` lies inside its block over ``b`` (the
    index over ``a`` is row-major over its names); None otherwise."""
    at = _axes_tuple(a) if a is not None else ()
    bt = _axes_tuple(b) if b is not None else ()
    if len(at) <= len(bt) or at[:len(bt)] != bt:
        return None
    rest = at[len(bt):]
    return rest[0] if len(rest) == 1 else rest


def _parts(x, dim: int, widths):
    return list(torch.split(x, widths, dim)) if len(widths) > 1 else [x]


def _join(parts, dim: int):
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0]


def reshard(x, dim: int, have: Axis, want: Axis,
            parts: Optional[Tuple[int, ...]] = None):
    """``x`` sharded over ``have`` along ``dim`` -> sharded over ``want``
    (None: replicated).  ``parts``: the global widths of the components
    packed along ``dim`` (``partition.packed_layout``), of which a rank's
    block holds its share of each, in order; each moves on its own.

    Where ``want``'s names begin with ``have``'s, the rank's new block lies
    inside its old one: a slice, no collective.  Where ``have``'s begin
    with ``want``'s, one all-gather over the names after them.  Otherwise
    one all-gather over ``have``, then a slice."""
    c = current()
    if c is None:
        return x
    have, want = _live(have, c), _live(want, c)
    if have == want:
        return x
    m = c.size(have)
    widths = [w // m for w in (parts or (x.shape[dim] * m,))]
    inner = _tail(want, have)
    if inner is not None:
        return _join([scatter_over(p, inner, dim)
                      for p in _parts(x, dim, widths)], dim)
    outer = _tail(have, want)
    over = outer if outer is not None else have
    g = gather_over(x, over, dim)
    if len(widths) > 1:     # k blocks of x's layout -> each part's k blocks
        blocks = [_parts(b, dim, widths)
                  for b in torch.chunk(g, c.size(over), dim)]
        g = [torch.cat([b[i] for b in blocks], dim)
             for i in range(len(widths))]
    else:
        g = [g]
    if outer is not None:
        return _join(g, dim)
    return _join([scatter_over(p, want, dim) for p in g], dim)


# ----------------------------------------------------------- model helpers
@dataclass(frozen=True)
class AttnShard:
    """How one attention layer is cut on this rank: the axes of the
    q / kv projections' columns and of ``wo``'s rows (params), of the
    query and kv heads (rules), of the serving cache's kv heads
    (``cache_axis``: the ``attn`` axis, None where the cache is cut along
    its slots), and the rank's first global query and kv head.  Outside
    ``spmd`` every axis is None and the rank holds every head."""
    q_cols: Axis = None
    kv_cols: Axis = None
    wo_rows: Axis = None
    heads: Axis = None
    kv_heads: Axis = None
    cache_kv: Axis = None
    n_heads: int = 0
    n_kv: int = 0
    h0: int = 0
    kv0: int = 0

    @staticmethod
    def of(n_heads: int, n_kv: int, head_dim: int) -> "AttnShard":
        c = current()
        if c is None:
            return AttnShard(n_heads=n_heads, n_kv=n_kv)
        h_ax = c.rule_axis("heads", n_heads)
        kv_ax = c.rule_axis("kv_heads", n_kv)
        return AttnShard(
            q_cols=c.param_axis("attn", n_heads * head_dim),
            kv_cols=c.param_axis("attn", n_kv * head_dim),
            wo_rows=c.param_axis("attn", n_heads * head_dim),
            heads=h_ax, kv_heads=kv_ax, cache_kv=c.param_axis("attn", n_kv),
            n_heads=n_heads, n_kv=n_kv,
            h0=c.index(h_ax) * (n_heads // c.size(h_ax)),
            kv0=c.index(kv_ax) * (n_kv // c.size(kv_ax)))

    def q(self, q):
        """Projected q (..., cols) -> sharded over the heads axis."""
        return reshard(q, -1, self.q_cols, self.heads)

    def kv(self, t):
        return reshard(t, -1, self.kv_cols, self.kv_heads)

    def to_cache(self, t):
        """K or V (..., kv heads, D) over the kv heads' axis -> over the
        cache's (the ``ep`` variants cut the cache finer)."""
        return reshard(t, -2, self.kv_heads, self.cache_kv)

    def from_cache(self, t):
        return reshard(t, -2, self.cache_kv, self.kv_heads)

    def kv_for_heads(self, k, v):
        """K/V (B, S, n, D) holding global kv heads [kv0, kv0 + n) ->
        the heads the rank's query heads read under the global GQA map
        h -> h * Hkv // H.  Returned as they are when the kernels' own
        map over the local counts gives the same heads (always outside
        ``spmd``), else selected per query head.  K/V replicated over an
        axis the heads are sharded over enter through
        ``replicate_over``."""
        extra = minus(self.heads, self.kv_heads)
        k, v = replicate_over(k, extra), replicate_over(v, extra)
        return self._select(k, v, self.kv0)

    def _wanted(self, first: int) -> List[int]:
        """The local indices, in K/V whose first global kv head is
        ``first``, of the kv heads the rank's query heads read."""
        c = current()
        hl = self.n_heads // (c.size(self.heads) if c is not None else 1)
        return [(self.h0 + j) * self.n_kv // self.n_heads - first
                for j in range(hl)]

    def _select(self, k, v, first: int):
        idx, n = self._wanted(first), k.shape[2]
        # the kernels map query head j to kv head j * n // hl (hl % n == 0)
        if len(idx) % n == 0 and \
                idx == [j * n // len(idx) for j in range(len(idx))]:
            return k, v
        sel = torch.tensor(idx, device=k.device)
        return k.index_select(2, sel), v.index_select(2, sel)

    def cached_kv_for_heads(self, k, v):
        """``kv_for_heads`` of K/V read from the cache (cut over
        ``cache_kv``): taken from the rank's cache block where it holds
        every kv head the rank's query heads read, else moved to the kv
        heads' cut first (``from_cache``)."""
        c = current()
        if c is not None and _live(self.cache_kv, c) != _live(self.kv_heads,
                                                              c):
            first = c.index(self.cache_kv) * k.shape[2]
            if all(0 <= i < k.shape[2] for i in self._wanted(first)):
                return self._select(k, v, first)
            k, v = self.from_cache(k), self.from_cache(v)
        return self.kv_for_heads(k, v)

    def head_param(self, t):
        """A replicated per-head-dim param (qk-norm's q scale) applied to
        the rank's query heads."""
        return replicate_over(t, self.heads)

    def kv_param(self, t):
        return replicate_over(t, self.kv_heads)

    def partial(self, o2d, wo):
        """o (..., local heads * D) @ ``wo``'s rows: the rank's term."""
        return reshard(o2d, -1, self.heads, self.wo_rows) @ wo

    def finish(self, y):
        """The terms summed over ``wo``'s row axis."""
        return reduce_over(y, self.wo_rows)

def join_axes(*axes: Axis) -> Axis:
    """The product axis of ``axes`` (mesh order), None when empty."""
    c = current()
    names = {a for ax in axes if ax is not None for a in _axes_tuple(ax)}
    order = [a for a in (c.sizes if c is not None else sorted(names))
             if a in names]
    return None if not order else (order[0] if len(order) == 1
                                   else tuple(order))


def minus(a: Axis, b: Axis) -> Axis:
    """The names of ``a`` not in ``b`` (None when none)."""
    if a is None:
        return None
    drop = set(_axes_tuple(b)) if b is not None else set()
    rest = tuple(x for x in _axes_tuple(a) if x not in drop)
    return None if not rest else (rest[0] if len(rest) == 1 else rest)


def check_runtime(cfg) -> None:
    """Raise ``NotImplementedError`` where the runtime cannot shard
    ``cfg`` under the active context (a no-op outside ``spmd``)."""
    why = unsharded_reason(cfg)
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why}")


def unsharded_reason(cfg) -> Optional[str]:
    """Why the runtime cannot shard ``cfg`` under the active context, None
    when it can (always outside ``spmd``): a Mamba2 component that does
    not divide the ``ssm`` axis (``partition.packed_refusal``); RWKV-6
    projections whose columns split a head.  Every other family, the
    encoder-decoder one included, is sharded."""
    c = current()
    if c is None:
        return None
    if cfg.family == "hybrid":
        ax = c.axes.get("ssm")
        return partition.packed_refusal(cfg, c.size(ax), ax)
    if cfg.family == "ssm":
        d, hk = cfg.d_model, cfg.ssm.rwkv_head_dim
        ax = c.param_axis("attn", d)
        if ax is not None and (d // hk) % c.size(ax):
            return (f"wr/wk/wv/wg/wo: {d} columns over {ax!r} "
                    f"({c.size(ax)} ranks) split a head of {hk}; the WKV "
                    "runs on whole heads")
    return None


def leaf_axis(name: str, shape, dim: int) -> Axis:
    """The axis param ``name`` of global ``shape`` is cut over along
    ``dim`` under the active context (its ``partition.param_pspec``),
    None when that dim is whole or outside ``spmd``."""
    c = current()
    if c is None:
        return None
    ax = partition.param_pspec(name, tuple(shape), c.mesh, c.axes)[dim]
    return ax if c.size(ax) > 1 else None


def kv_seq_axis(n_kv: int) -> Axis:
    """The axis a KV cache's slots are cut over under the active context:
    ``make_cache_pspec_fn`` cuts the sequence where the ``n_kv`` kv heads
    (the global count) do not divide the ``attn`` axis.  None where the
    heads divide it, over one rank, or outside ``spmd``.  ``cache_specs``
    refuses a cache whose slots do not divide the axis either, so a cache
    the runtime built is cut along the sequence exactly when this is
    not None."""
    c = current()
    if c is None:
        return None
    ax = c.axes.get("attn", "model")
    m = c.size(ax)
    return ax if m > 1 and n_kv % m else None


def cache_axis(n: int) -> Axis:
    """The axis ``make_cache_pspec_fn`` cuts a serving cache's per-head or
    per-channel dim of global size ``n`` over (the ``attn`` axis: an SSM
    state's heads, a conv tail's channels, a token shift's width), None
    when whole or outside ``spmd``."""
    c = current()
    return None if c is None else c.param_axis("attn", n)


def kv_heads_axis(n_kv: int) -> Axis:
    """The axis the rules cut ``n_kv`` kv heads over (None when whole or
    outside ``spmd``): the K/V a layer projects, before the cache."""
    c = current()
    return None if c is None else c.rule_axis("kv_heads", n_kv)


def axis_ranks(axis: Axis) -> int:
    """Ranks along ``axis`` in the active context (1 outside)."""
    c = current()
    return 1 if c is None else c.size(axis)


def param_axis(family: str, n: int) -> Axis:
    """``SpmdContext.param_axis`` of the active context (None outside)."""
    c = current()
    return None if c is None else c.param_axis(family, n)


def ffn_axis(n: int) -> Axis:
    """The axis the FFN's d_ff (``n``) is sharded over, None outside
    ``spmd`` or when replicated."""
    c = current()
    return None if c is None else c.param_axis("ffn", n)


def vocab_axis(n: int) -> Axis:
    c = current()
    return None if c is None else c.param_axis("vocab", n)


def expert_axis(n: int) -> Axis:
    """The axis the MoE's experts (``n``) are sharded over (the ``ep``
    variants), None otherwise."""
    c = current()
    return None if c is None else c.param_axis("expert", n)


def axis_offset(axis: Axis, n_local: int) -> int:
    """The rank's first global index along a dim sharded over ``axis``
    with ``n_local`` entries a rank (0 outside ``spmd``)."""
    c = current()
    return 0 if c is None or axis is None else c.index(axis) * n_local


def mean_over_batch(x):
    """A per-rank mean over the batch dim -> the global mean (equal local
    batches): the MoE's load statistics under a data axis."""
    c = current()
    ax = None if c is None else c.batch_axis()
    if ax is None:
        return x
    return reduce_over(x, ax) / c.size(ax)


def sum_over_batch(x):
    c = current()
    ax = None if c is None else c.batch_axis()
    return x if ax is None else reduce_over(x, ax)


def sync_grads(grads):
    """Sum each gradient over the batch axes (the data-parallel
    all-reduce; the model axis needs none: a replicated param's gradient
    is already whole on every rank).  In place; returns ``grads``."""
    from repro_torch.viscosity.lang import tree_leaves
    c = current()
    ax = None if c is None else c.batch_axis()
    if ax is None:
        return grads
    for g in tree_leaves(grads):
        if isinstance(g, torch.Tensor):
            g.copy_(c.comm.all_reduce(g.float(), ax).to(g.dtype))
    return grads


def sum_by_spec(values: torch.Tensor, tree, specs) -> torch.Tensor:
    """The sum over a whole tree of per-leaf local sums: ``values[i]`` is
    the sum over leaf ``i`` of ``tree`` (this rank's shard, leaves in
    ``partition.flatten`` order).  Each leaf's value is summed over the
    mesh axes its spec (``specs``, the full tree's) cuts it over, in f32,
    one all-reduce per set of axes; a replicated leaf's counts once."""
    c = current()
    if specs is None:
        raise ValueError("under spmd a sum over a sharded tree needs each "
                         "leaf's PartitionSpec (partition.params_pspecs)")
    flat_specs = partition.flatten(specs)
    paths = list(partition.flatten(tree))
    groups: Dict[Axis, List[int]] = {}
    for i, path in enumerate(paths):
        cut = [a for a in flat_specs[path] if c.size(a) > 1]
        groups.setdefault(join_axes(*cut), []).append(i)
    total = torch.zeros((), dtype=torch.float32, device=values.device)
    for ax, idx in groups.items():
        part = values[idx].float().sum()
        total = total + (part if ax is None
                         else c.comm.all_reduce(part, ax))
    return total


# ------------------------------------------------------------------ caches
def cache_specs(model, batch: int, max_len: int):
    """The PartitionSpecs of ``model``'s serving cache (``make_cache_pspec
    _fn`` over this rank's mesh): a KV cache's kv heads, or its slots where
    the heads do not divide (``kv_seq_axis``: decode combines the ranks'
    partial softmaxes); a recurrent state's heads or channels over the
    ``attn`` axis, whatever the axis of the params that write it
    (``state_axes``: the step moves the state between the two cuts).  A
    stacked cache's layers stay whole, as many as its rows included.
    Raises ``NotImplementedError`` where the runtime cannot serve them: a
    KV cache whose heads and slots both do not divide, or a packed state
    (Mamba2's conv tail) whose components do not divide the cache's
    axis."""
    c = current()
    meta = model.init_cache(batch, max_len, device=torch.device("meta"))
    attn_axis = c.axes.get("attn", "model")
    specs = partition.tree_pspecs(
        meta, c.mesh, partition.make_cache_pspec_fn(batch, c.mesh,
                                                    attn_axis=attn_axis))
    flat_meta = partition.flatten(meta)
    m = c.size(attn_axis)
    layout = partition.packed_layout(model.cfg)
    for path, spec in partition.flatten(specs).items():
        name = path.split("/")[-1]
        shape = flat_meta[path].shape
        if name in ("k", "v") and m > 1 and shape[-2] % m \
                and spec[-3] is None:
            raise NotImplementedError(
                f"cache leaf {path} {tuple(shape)}: neither its {shape[-2]} "
                f"kv heads nor its {shape[-3]} slots divide {attn_axis!r} "
                f"({m} ranks), so it is cut by neither; a max_len that is a "
                f"multiple of {m} cuts its slots")
        partition.packed_cut(path, spec, layout, c.mesh)   # raises
    return meta, specs


def state_axes(cfg) -> Dict[str, Tuple[int, Axis, Axis]]:
    """Per recurrent-state cache leaf of ``cfg``'s layers: (its dim, the
    axis the cache cuts it over, the axis of the params that write it),
    under the active context (empty outside ``spmd``).  The cache cuts a
    state over the ``attn`` axis (``cache_axis``); Mamba2's ``ssm`` heads
    and ``conv`` channels are written by params on the ``ssm`` axis, which
    the ``attn2d`` variant cuts finer and the ``ep`` variants coarser, so
    the step moves them (``reshard``).  RWKV-6's ``wkv`` heads come from
    ``wr``'s columns, on the ``attn`` axis too.  A token shift is gathered
    whole where it is read."""
    c = current()
    if c is None:
        return {}
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        heads = d_inner // cfg.ssm.head_dim
        conv = d_inner + 2 * cfg.ssm.state_dim
        writer = leaf_axis("in_proj", (cfg.d_model, d_inner + conv + heads),
                           -1)
        return {"ssm": (-3, cache_axis(heads), writer),
                "conv": (-1, cache_axis(conv), writer)}
    if cfg.family == "ssm":
        return {"wkv": (-3, cache_axis(cfg.d_model // cfg.ssm.rwkv_head_dim),
                        leaf_axis("wr", (cfg.d_model, cfg.d_model), -1))}
    return {}


def init_cache(model, batch: int, max_len: int, device=None):
    """``model.init_cache`` outside ``spmd``; inside, this rank's shard of
    it (its kv heads, or its slots, and the positions, cut as
    ``make_cache_pspec_fn`` says), allocated at its local shape."""
    if current() is None:
        return model.init_cache(batch, max_len, device=device)
    c = current()
    meta, specs = cache_specs(model, batch, max_len)
    flat_specs = partition.flatten(specs)

    def alloc(path, leaf):
        shape = partition.local_shape(leaf.shape, flat_specs[path], c.mesh)
        if path.split("/")[-1] == "pos":
            return torch.full(shape, -1, dtype=leaf.dtype, device=device)
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return partition.map_with_path(meta, alloc)


def pos_axis(cache) -> Axis:
    """The axis a heads-cut KV cache's positions are sharded over along
    the sequence (``make_cache_pspec_fn``'s "pos" rule), None when whole
    or when k/v are cut along the sequence with them
    (``kv_seq_axis``)."""
    c = current()
    if c is None or cache["pos"].shape[-1] == cache["k"].shape[2]:
        return None
    return c.axes.get("attn", "model")


def collective_log() -> Optional[CollectiveLog]:
    c = current()
    return None if c is None else c.comm.log


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """The mesh coordinates of global rank ``rank`` (row-major)."""
    return partition.mesh_coords(mesh)[rank]


def devices_spanned(mesh, axis: Axis) -> List[int]:
    """The global ranks of rank 0's group over ``axis``."""
    sizes = mesh_sizes(mesh)
    coords = partition.mesh_coords(mesh)
    rest = [a for a in sizes if a not in _axes_tuple(axis)]
    return [r for r, cd in enumerate(coords) if all(cd[a] == 0
                                                     for a in rest)]


__all__ = ["CollectiveLog", "CountingComm", "GroupComm", "SpmdContext",
           "AttnShard", "spmd", "current", "bound", "logical_sizes",
           "reduce_over",
           "replicate_over", "gather_over", "scatter_over", "reshard",
           "ffn_axis", "vocab_axis", "expert_axis", "axis_offset",
           "leaf_axis", "cache_axis", "kv_seq_axis", "axis_ranks",
           "state_axes", "kv_heads_axis",
           "check_runtime", "unsharded_reason", "mean_over_batch",
           "sum_over_batch", "sync_grads", "sum_by_spec", "cache_specs",
           "init_cache", "pos_axis", "collective_log", "rank_coords",
           "devices_spanned"]
