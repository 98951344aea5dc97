"""Parameter / cache / batch PartitionSpecs for a device mesh (the port's
``launch/partition.py``), and the cut of a full tree into one rank's
shards.

Plain Python over shapes and a mesh's ``{axis: size}`` (a port ``Mesh``,
a mapping, or any object with a ``shape`` mapping).  Name-driven rules
(we control every param name):
  * column-sharded projections (last dim over "model"): wq wk wv wg wr w1 w3
    cwk cwr in_proj router w_lora_a and lm_head.w
  * row-sharded projections (dim -2 over "model"): wo w2 cwv out_proj and
    the embedding table (vocab dim)
  * per-head vectors (dim -1): bq bk bv A_log D dt_bias conv ...;
    ln/norm/mix replicated
Indivisible dims fall back to replication (a hillclimb target).

Batch inputs shard over ("pod","data"); decode caches shard batch over
("pod","data") and kv-heads over "model" when divisible (else the
sequence dim).  One difference from the reference: a stacked cache with
as many layers as rows keeps its layers whole (the reference's rule
takes its layer dim for the batch).  ``zero1_specs`` adds the data axes
to each leaf's first free dim, the layout of ZeRO-1's AdamW moments.

``tree_pspecs`` walks nested dicts with the path keys of
``jax.tree_util`` (sorted dict keys joined by "/"); ``shard_tree`` cuts a
full tree to one rank's local shards and ``unshard_tree`` puts shards
back together.

Packed leaves (``packed_layout``): Mamba2's ``in_proj`` holds z, x, B, C
and dt in one column range, its ``conv_w``/``conv_b`` and the ``conv``
cache leaf x, B and C.  XLA cuts such a leaf as a contiguous range and
reshuffles where a component is read; the port's runtime reads a rank's
block in place, so ``shard_tree`` gives rank r the r-th 1/m of every
component, in order (the columns permuted before the contiguous cut the
unchanged spec makes), and ``unshard_tree`` inverts it.  A block's bytes
are the spec's; ``param_pspec`` and ``make_cache_pspec_fn`` do not know
the layout.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.launch.sharding import (DEFAULT_RULES, PartitionSpec as P,
                                         axis_size, mesh_sizes)

COL = {"wq", "wk", "wv", "wg", "wr", "w1", "w3", "cwk", "cwr", "in_proj",
       "router", "w_lora_a"}
ROW = {"wo", "w2", "cwv", "out_proj", "table"}
VEC = {"bq", "bk", "bv", "conv_b", "A_log", "D", "dt_bias", "conv_w",
       "w_lora_b"}
HEAD2 = {"u"}
LM_HEAD = {"w"}


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _model_size(mesh) -> int:
    return mesh_sizes(mesh).get("model", 1)


def _axis_size(mesh, axis) -> int:
    return axis_size(mesh_sizes(mesh), axis)


# Axis assignment per parameter family; variants (launch/variants.py)
# override these (e.g. 2D attention sharding, expert parallelism).
DEFAULT_AXES = {"attn": "model", "ffn": "model", "vocab": "model",
                "expert": None, "ssm": "model"}


def _batch_axes(mesh):
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return axes if axes else None


ATTN_NAMES = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "wg", "wr"}


def param_pspec(path: str, shape, mesh, axes=None) -> P:
    axes = axes or DEFAULT_AXES
    name = path.split("/")[-1]
    is_moe = "moe" in path and name in ("w1", "w2", "w3")
    if name in ATTN_NAMES:
        ax = axes["attn"]
    elif name in LM_HEAD or name == "table":
        ax = axes["vocab"]
    elif name in ("in_proj", "out_proj", "conv_w", "conv_b", "A_log", "D",
                  "dt_bias"):
        ax = axes["ssm"]
    else:
        ax = axes["ffn"]
    m = _axis_size(mesh, ax)
    nd = len(shape)
    spec = [None] * nd
    if is_moe and axes.get("expert") and nd >= 3 and \
            _div(shape[-3], _axis_size(mesh, axes["expert"])):
        spec[-3] = axes["expert"]
    if name in COL and nd >= 2:
        if _div(shape[-1], m):
            spec[-1] = ax
    elif name in ROW and nd >= 2:
        if _div(shape[-2], m):
            spec[-2] = ax
    elif name in LM_HEAD and nd >= 2 and "lm_head" in path:
        if _div(shape[-1], m):
            spec[-1] = ax
    elif name in VEC or name in HEAD2:
        if nd >= 1 and _div(shape[-1], m) and shape[-1] >= m:
            if name in HEAD2 and nd >= 2:
                if _div(shape[-2], m):
                    spec[-2] = ax
            else:
                spec[-1] = ax
    return P(*spec)


def map_with_path(tree, fn, prefix=()):
    """``fn(path, leaf)`` over a nested dict (tuples and lists by index),
    keys in sorted order as ``jax.tree_util`` flattens a dict; the result
    has ``tree``'s structure."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(tree[k], fn, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        out = [map_with_path(v, fn, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn("/".join(prefix), tree)


def flatten(tree) -> Dict[str, Any]:
    """``{path: leaf}`` with ``tree_pspecs``'s paths."""
    out: Dict[str, Any] = {}
    map_with_path(tree, lambda path, leaf: out.__setitem__(path, leaf))
    return out


def tree_pspecs(tree, mesh, fn: Callable) -> Any:
    """``fn(path, shape, mesh)`` at every leaf of ``tree``."""
    return map_with_path(tree, lambda path, leaf: fn(
        path, tuple(leaf.shape), mesh))


def params_pspecs(params, mesh, axes=None):
    return tree_pspecs(params, mesh,
                       lambda p, s, m: param_pspec(p, s, m, axes))


def params_shardings(params, mesh, axes=None):
    """Per leaf ``(mesh, spec)``, the port's ``NamedSharding``."""
    return map_with_path(params_pspecs(params, mesh, axes),
                         lambda _, s: (mesh, s))


def opt_pspecs(opt_state, params_specs):
    """AdamW moments mirror params; count replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(count=P(), mu=params_specs, nu=params_specs)


def zero1_spec(spec: P, shape, mesh) -> P:
    """``spec`` with the data axes (("pod", "data") present in ``mesh``)
    added on the first dim it leaves whole whose global size they divide,
    the reference's ZeRO-1 ``_extend`` (``launch/dryrun.py``); unchanged
    where no such dim is."""
    sizes = mesh_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not dp_axes:
        return spec
    dp_total = max(1, math.prod(sizes[a] for a in dp_axes))
    lst = list(spec) + [None] * (len(shape) - len(spec))
    for i, d in enumerate(shape):
        if lst[i] is None and d % dp_total == 0:
            lst[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            break
    return P(*lst)


def zero1_specs(specs, shapes, mesh):
    """Every leaf's ``zero1_spec``: ``specs`` a tree of PartitionSpecs
    (``params_pspecs``), ``shapes`` the full tree (tensors or anything
    with a ``shape``) of the same structure.  The AdamW moments live at
    these specs under ZeRO-1, each rank holding 1/dp of them."""
    flat = flatten(shapes)
    return map_with_path(specs, lambda path, s: zero1_spec(
        s, tuple(flat[path].shape), mesh))


def zero1_dim(spec: P, zspec: P) -> Optional[int]:
    """The dim ``zero1_spec`` added the data axes on, None when it added
    none."""
    for i, z in enumerate(zspec):
        if (spec[i] if i < len(spec) else None) != z:
            return i
    return None


# ------------------------------------------------------------- activations
def batch_pspec(path: str, shape, mesh) -> P:
    sizes = mesh_sizes(mesh)
    b_axes = _batch_axes(mesh)
    total = math.prod(sizes[a] for a in (b_axes or ())) or 1
    nd = len(shape)
    spec = [None] * nd
    if nd >= 1 and b_axes and _div(shape[0], total):
        spec[0] = b_axes
    return P(*spec)


def cache_pspec(path: str, shape, mesh) -> P:
    """Decode cache leaves: replaced by ``make_cache_pspec_fn``, which
    knows the serving batch."""
    raise NotImplementedError  # replaced by make_cache_pspec_fn


# The dims of each serving cache leaf, by name, stacked over its layers:
# (L, B, S, Hkv, D) k, v and an encoder-decoder's cross-KV ("0", "1"),
# (L, B, S) pos, (L, B, H, N, P) ssm, (L, B, H, K, V) wkv, (L, B, K-1, C)
# conv, (L, B, D) the token shifts.
CACHE_LEAF_DIMS = {"k": 5, "v": 5, "0": 5, "1": 5, "pos": 3, "ssm": 5,
                   "wkv": 5, "conv": 4, "shift_tm": 3, "shift_cm": 3}


def cache_batch_dim(path: str, nd: int) -> int:
    """The batch dim of an ``nd``-dim cache leaf at ``path``, from its
    layout, whatever the sizes: dim 1 of a stacked (L, B, ...) leaf, dim
    0 of one layer's (B, ...) leaf (the reference keeps gemma3-1b's tail
    layers unstacked).  Raises ``ValueError`` for a leaf of another
    layout."""
    name = path.split("/")[-1]
    full = CACHE_LEAF_DIMS.get(name)
    if full is None or nd not in (full, full - 1):
        raise ValueError(f"cache leaf {path}: {nd} dims, not a stacked "
                         f"layout ({full} dims, or one layer's {full} - 1)"
                         if full else f"cache leaf {path}: no known layout")
    return 1 - (full - nd)


def make_cache_pspec_fn(batch: int, mesh, attn_axis="model"):
    sizes = mesh_sizes(mesh)
    b_axes = _batch_axes(mesh)
    total = math.prod(sizes[a] for a in (b_axes or ())) or 1
    m = axis_size(sizes, attn_axis)

    def fn(path: str, shape, _mesh) -> P:
        nd = len(shape)
        spec = [None] * nd
        b_dim = cache_batch_dim(path, nd)
        if b_axes and _div(batch, total):
            spec[b_dim] = b_axes
        name = path.split("/")[-1]
        if name in ("k", "v") and nd >= 2:
            # (..., B, S, Hkv, D): kv-heads over model if divisible, else
            # the sequence dim (a partial-softmax combine across ranks)
            if _div(shape[-2], m):
                spec[-2] = attn_axis
            elif _div(shape[-3], m):
                spec[-3] = attn_axis
        elif name == "pos" and nd >= 2:
            if _div(shape[-1], m):
                spec[-1] = attn_axis
        elif name == "ssm" and nd >= 3:
            # (L, B, H, N, P): ssm heads over model
            if _div(shape[-3], m):
                spec[-3] = attn_axis
        elif name == "wkv" and nd >= 3:
            if _div(shape[-3], m):
                spec[-3] = attn_axis
        elif name == "conv" and nd >= 1 and _div(shape[-1], m):
            spec[-1] = attn_axis
        elif name in ("shift_tm", "shift_cm") and _div(shape[-1], m):
            spec[-1] = attn_axis
        return P(*spec)

    return fn


def rules_for(cfg, mesh) -> Dict[str, Any]:
    """Per-arch logical-axis rules: drop indivisible shardings (recorded as
    replication; a hillclimb target)."""
    rules = dict(DEFAULT_RULES)
    m = _model_size(mesh)
    if cfg.num_heads % m:
        rules["heads"] = None
    if cfg.num_kv_heads % m:
        rules["kv_heads"] = None
    if cfg.d_ff % m:
        rules["mlp"] = None
    if cfg.vocab_size % m:
        rules["vocab"] = None
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
        if d_inner % m:
            rules["ssm_inner"] = None
        nheads = (d_inner // cfg.ssm.head_dim if cfg.family == "hybrid"
                  else cfg.d_model // max(cfg.ssm.rwkv_head_dim, 1))
        if nheads % m:
            rules["ssm_heads"] = None
    return rules


# ---------------------------------------------------------------- shards
def axis_index(sizes: Mapping[str, int], coords: Mapping[str, int],
               axis) -> int:
    """This rank's index along ``axis`` (a name or a tuple of names, their
    product row-major; 0 for None)."""
    if axis is None:
        return 0
    names = axis if isinstance(axis, tuple) else (axis,)
    idx = 0
    for a in names:
        idx = idx * sizes.get(a, 1) + coords.get(a, 0)
    return idx


def local_shape(shape: Sequence[int], spec: P, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` leaf under ``spec``."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, ax in enumerate(spec):
        m = axis_size(sizes, ax)
        if out[d] % m:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {ax!r} ({m} ranks)")
        out[d] //= m
    return tuple(out)


def shard_leaf(t, spec: P, mesh, coords: Mapping[str, int]):
    """Rank ``coords``' shard of ``t`` under ``spec`` (views: a slice per
    sharded dim)."""
    sizes = mesh_sizes(mesh)
    for d, ax in enumerate(spec):
        m = axis_size(sizes, ax)
        if m == 1:
            continue
        n = t.shape[d] // m
        t = t.narrow(d, axis_index(sizes, coords, ax) * n, n)
    return t


def leaf_cutter(mesh, coords: Mapping[str, int], axes=None):
    """``cut(path, t)``: rank ``coords``' block of leaf ``path``'s tensor
    ``t`` (a view), cut by ``param_pspec`` on ``t``'s own shape, which
    reads only a leaf's trailing dims: one layer of a stacked leaf is cut
    as the stack is.  What ``LMModel.init_keyed`` keeps on a rank (a
    Mamba2 packed leaf, cut by component, is not covered)."""
    def cut(path, t):
        return shard_leaf(t, param_pspec(path, tuple(t.shape), mesh, axes),
                          mesh, coords)
    return cut


Layout = Mapping[str, Tuple[Tuple[str, int], ...]]


def packed_layout(cfg) -> Layout:
    """Leaf name -> its components ((name, columns), ...) in column order,
    for the leaves that pack several tensors along their last dim: a
    hybrid config's Mamba2 ``in_proj`` (z, x, B, C, dt), ``conv_w``,
    ``conv_b`` and ``conv`` cache (x, B, C).  Empty for other families."""
    if cfg.family != "hybrid" or cfg.ssm is None:
        return {}
    d_inner = cfg.ssm.expand * cfg.d_model
    N = cfg.ssm.state_dim
    xbc = (("x", d_inner), ("B", N), ("C", N))
    return {"in_proj": (("z", d_inner),) + xbc
            + (("dt", d_inner // cfg.ssm.head_dim),),
            "conv_w": xbc, "conv_b": xbc, "conv": xbc}


def _component_refusal(name: str, comps, m: int, axis) -> Optional[str]:
    total = sum(w for _, w in comps)
    for comp, w in comps:
        if w % m:
            return (f"{name}: its {comp} component ({w} of {total} "
                    f"columns) does not divide over {axis!r} ({m} ranks); "
                    "a rank's block holds 1/m of every component")
    return None


def packed_refusal(cfg, m: int, axis=None) -> Optional[str]:
    """Why ``cfg``'s packed leaves cannot be cut ``m`` ways by component
    (naming the leaf and the component), None when they can."""
    if m <= 1:
        return None
    for name, comps in packed_layout(cfg).items():
        why = _component_refusal(name, comps, m, axis)
        if why is not None:
            return why
    return None


def _block_columns(comps, m: int, r: int):
    """The columns, in the full leaf, of rank r's block: the r-th 1/m of
    each component, in component order."""
    import torch
    cols, off = [], 0
    for _, w in comps:
        n = w // m
        cols.append(torch.arange(off + r * n, off + (r + 1) * n))
        off += w
    return torch.cat(cols)


def packed_cut(path: str, spec: P, layout: Optional[Layout], mesh):
    """(components, m, axis) when the leaf at ``path`` is packed and its
    last dim cut; raises ``NotImplementedError`` naming the leaf and the
    component that does not divide."""
    comps = (layout or {}).get(path.split("/")[-1])
    if not comps or not len(spec) or spec[-1] is None:
        return None
    m = _axis_size(mesh, spec[-1])
    if m <= 1:
        return None
    why = _component_refusal(path, comps, m, spec[-1])
    if why is not None:
        raise NotImplementedError(why)
    return comps, m, spec[-1]


def shard_tree(tree, specs, mesh, coords: Mapping[str, int],
               layout: Optional[Layout] = None):
    """Cut a full tree to the local shards of the rank at mesh
    ``coords`` ({axis: index}); ``specs`` has ``tree``'s structure.  A
    leaf named in ``layout`` (``packed_layout``) whose last dim is cut
    gives the rank its block of every component (a copy); every other
    leaf a view."""
    flat = flatten(specs)
    sizes = mesh_sizes(mesh)

    def cut(path, t):
        spec = flat[path]
        packed = packed_cut(path, spec, layout, mesh)
        if packed is not None:
            comps, m, ax = packed
            cols = _block_columns(comps, m, axis_index(sizes, coords, ax))
            t = t.index_select(-1, cols.to(t.device))
            spec = P(*spec[:-1], None)
        return shard_leaf(t, spec, mesh, coords)
    return map_with_path(tree, cut)


def mesh_coords(mesh) -> list:
    """Every rank's ``{axis: index}``, row-major over the mesh."""
    sizes = mesh_sizes(mesh)
    names = list(sizes)
    out = [{}]
    for a in names:
        out = [{**c, a: i} for c in out for i in range(sizes[a])]
    return out


def unshard_tree(shards: Sequence, specs, mesh,
                 layout: Optional[Layout] = None):
    """The full tree from every rank's shards (``shards`` in
    ``mesh_coords`` order): the inverse of ``shard_tree`` (with the same
    ``layout``); a replicated dim takes the first rank's copy."""
    import torch
    sizes = mesh_sizes(mesh)
    coords = mesh_coords(mesh)
    flat_specs = flatten(specs)
    flats = [flatten(sh) for sh in shards]

    def join(path, _):
        spec = flat_specs[path]
        sharded = [(d, ax) for d, ax in enumerate(spec)
                   if axis_size(sizes, ax) > 1]
        # one rank per distinct block: the block index along each sharded
        # dim, the first rank that holds it
        blocks: Dict[tuple, Any] = {}
        for c, f in zip(coords, flats):
            key = tuple(axis_index(sizes, c, ax) for _, ax in sharded)
            blocks.setdefault(key, f[path])
        def build(level, prefix):
            if level == len(sharded):
                return blocks[prefix]
            d, ax = sharded[level]
            return torch.cat([build(level + 1, prefix + (i,))
                              for i in range(axis_size(sizes, ax))], dim=d)
        full = build(0, ())
        packed = packed_cut(path, spec, layout, mesh)
        if packed is not None:      # blocks in rank order -> components
            comps, m, _ = packed
            cols = torch.cat([_block_columns(comps, m, r) for r in range(m)])
            out = torch.empty_like(full)
            out[..., cols.to(full.device)] = full
            full = out
        return full
    return map_with_path(shards[0], join)
