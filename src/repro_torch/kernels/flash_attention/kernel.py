"""Flash-attention forward on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``flash_attention_bhsd``
(src/repro/kernels/flash_attention/kernel.py).  The CUDA kernel is
warp-specialized: a producer warp fills a ring of K/V stages with TMA,
and one or two consumer warpgroups run ``wgmma`` for Q K^T and P V with
the online softmax in registers.  Head dims up to 128 take any (D, Dv);
above 128 (gemma2-2b's 256) D and Dv take the same number of 64-column
boxes, 3 or 4, with one consumer warpgroup a block (``COMPILED_WIDE``).

``plan`` is the launch plan in plain Python, the same on every device:
rows a block, ring depth, shared memory and the persistent grid, from the
shapes and, optionally, the tuned knobs (``nwg``, ``stages``, ``per_sm``;
the ``flash_attention`` hw space of ``kernels/tuning``).  ``resolve``
gives a CUDA call's plan: the tuning cache's entry for its shape, dtype
and routing plan where one is admissible at the call's real widths, else
the default; once per call signature and plan key.  On a CUDA tensor the wrapper reads q, k and v through their
strides (any 4-D view whose head dim is contiguous and whose other strides
are multiples of 16 bytes; ``tma_operand`` pads the head dim of anything
else), allocates the output in the model's (B, S, H, Dv) order, returns
it as a (B, H, S, Dv) view, and launches, or raises; on a CPU tensor it
runs the plain version, ``attention_ref_blocked`` (the kernel's blocked
algorithm in PyTorch), with the reference's 128 x 128 tiles and no tuning
lookup (its tiles have no Hopper meaning).  ``flash_attention_bhsd.launches``
counts CUDA launches and nothing else; ``flash_attention_bhsd.plans``
counts them by (shape, knobs).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import struct
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.flash_attention.ref import attention_ref_blocked

_NAME = "flash_attention"
_I = ctypes.c_int
_PROTOTYPES = {
    "flash_attention_fwd": (ctypes.c_char_p,),       # _HEAD + _TAIL
    "flash_attention_smem_bytes": (_I, _I, _I, _I),  # nwg, kd, vb, stages
}
# ``Params`` in csrc/flash_attention.cu, field for field, in two parts:
# the q, k, v, o, fault-mask and stream pointers; then the (b, h, s)
# element strides of q, k and v; B, H, Hkv, Sq, Skv, D, Dv, lanes, kv_len,
# causal, window, nwg, stages, grid, fault kind and the struct's size;
# scale, softcap, fault value and gain.  One packed argument costs
# the host a fraction of what forty ctypes arguments do.
_HEAD = struct.Struct("<6Q")
_TAIL = struct.Struct("<9q16i4f")
# per call signature (layout, shapes, strides, dtypes, devices, options,
# routing-plan key, explicit knobs) whose operands the kernel reads in
# place: the checked call's packed tail, output shape, real width,
# fault-mask pointer and plan record, so that a repeated call (every layer
# of a prefill) skips the checks, the tuning lookup and the packing;
# emptied when the tuning cache changes
_CALLS: Dict[tuple, tuple] = tuning.memo()
_CALLS_KEEP = 1024
DMAX = 256                # the CUDA kernel's widest head dim
# (kd, vb) box pairs compiled above two boxes (csrc/flash_attention.cu
# ``dispatch``): one consumer warpgroup a block, one block a SM
COMPILED_WIDE = ((3, 3), (4, 4))
TILE = 64                 # query rows a warpgroup; head dims a box; keys a
                          # K/V stage
SM_COUNT = 132            # H100 SXM
SMEM_LIMIT = 232_448      # a Hopper block's dynamic shared memory
SMEM_SM = 233_472         # an SM's shared memory, 1 KB of it kept a block
MAX_STAGES = 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def ring_bytes(nwg: int, kd: int, vb: int, stages: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in
    csrc/flash_attention.cu): two Q tiles of ``nwg * kd`` boxes of 64 rows
    x 64 head dims; ``stages`` K/V stages of ``kd + vb`` boxes of 64 keys;
    two mbarriers a Q tile and two a stage; 1024 bytes to align the
    swizzled boxes."""
    return (2 * nwg * kd * TILE * 128 + stages * (kd + vb) * TILE * 128
            + 8 * (4 + 2 * stages) + 1024)


@dataclasses.dataclass(frozen=True)
class Plan:
    nwg: int                       # consumer warpgroups (64 query rows each)
    kd: int                        # 64-column boxes of a q / k row
    vb: int                        # 64-column boxes of a v row
    stages: int                    # K/V stages in the ring
    smem: int                      # dynamic shared memory a block
    blocks_per_sm: int             # what the ring was sized for
    items: int                     # (h, query tile, b) work items
    grid: int                      # persistent blocks, each dealt items

    def knobs(self) -> Dict[str, int]:
        """The tunable knobs this plan was made with."""
        return {"nwg": self.nwg, "stages": self.stages,
                "per_sm": self.blocks_per_sm}


@functools.lru_cache(maxsize=256)
def plan(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int, Dv: int, *,
         nwg: Optional[int] = None, stages: Optional[int] = None,
         per_sm: Optional[int] = None) -> Plan:
    """The launch plan of one call, from its shapes and any knob given.
    An item is 64 query rows of one (b, h) for each consumer warpgroup.
    By default: two warpgroups (128 rows: K and V cross shared memory once
    for twice the rows) where such items still outnumber the SMs, else one
    (two blocks a SM where the items outnumber the SMs and two rings fit).
    Above 128 head dims a block has one warpgroup, whose 64 x 256 f32 O
    takes 128 registers a thread, and the SM one block.  The grid is
    persistent: one block per SM slot, dealt the items in turn.  64 keys a
    K/V stage, and as many stages as fit, 2 to 4.

    Knobs come all three or none, and must be ones the kernel takes:
    ``nwg`` 2 only up to two 64-column boxes, ``per_sm`` 2 only with one
    warpgroup, and a ring of ``stages`` (2 to 4) within the block's budget
    (half an SM less 1 KB at two blocks a SM); anything else raises
    ValueError."""
    if min(B, H, Hkv, Sq, Skv, D, Dv) < 1:
        raise ValueError(f"flash_attention: empty shape "
                         f"{(B, H, Hkv, Sq, Skv, D, Dv)}")
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} % Hkv={Hkv}")
    if D > DMAX or Dv > DMAX:
        raise ValueError(f"flash_attention: head dims {D}, {Dv} exceed "
                         f"{DMAX}")
    kd, vb = _ceil(D, TILE), _ceil(Dv, TILE)
    wide = max(kd, vb) > 2
    if wide and (kd, vb) not in COMPILED_WIDE:
        raise ValueError(f"flash_attention: head dims {D}, {Dv} take "
                         f"(kd, vb) = ({kd}, {vb}) boxes of 64; above two "
                         f"boxes only {COMPILED_WIDE} are compiled")
    if (nwg, stages, per_sm) != (None, None, None) and not (
            nwg in (1, 2) and per_sm in (1, 2) and stages in range(
                2, MAX_STAGES + 1)
            and (nwg == 1 or not wide) and (per_sm == 1 or nwg == 1)
            and ring_bytes(nwg, kd, vb, stages) <= min(
                SMEM_LIMIT, SMEM_SM // per_sm - 1024)):
        raise ValueError(f"flash_attention: knobs nwg={nwg} stages={stages} "
                         f"per_sm={per_sm} do not fit head dims {D}, {Dv} "
                         f"((kd, vb) = ({kd}, {vb}))")
    if nwg is None:
        nwg = 2 if not wide and B * H * _ceil(Sq, 2 * TILE) >= SM_COUNT \
            else 1
    items = B * H * _ceil(Sq, TILE * nwg)
    if per_sm is None:
        # two one-warpgroup blocks a SM where the items outnumber the SMs
        # and two two-stage rings fit in its shared memory
        per_sm = 2 if (nwg == 1 and items > SM_COUNT and ring_bytes(
            nwg, kd, vb, 2) <= SMEM_SM // 2 - 1024) else 1
        budget = min(SMEM_LIMIT, SMEM_SM // per_sm - 1024)
        stages = max(s for s in range(2, MAX_STAGES + 1)
                     if s == 2 or ring_bytes(nwg, kd, vb, s) <= budget)
    return Plan(nwg=nwg, kd=kd, vb=vb, stages=stages,
                smem=ring_bytes(nwg, kd, vb, stages), blocks_per_sm=per_sm,
                items=items, grid=min(items, SM_COUNT * per_sm))


def resolve(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int, Dv: int,
            dtype=torch.bfloat16) -> Plan:
    """The plan of a CUDA call: the tuning cache's ``flash_attention`` hw
    entry for the canonical shape (B, Sq, Skv, H, Hkv, D), the dtype and
    the active routing-plan key, where ``plan`` takes it at the call's real
    widths; else the default plan.  Memoized until the cache changes."""
    return tuning.resolve_plan(
        "flash_attention", (B, Sq, Skv, H, Hkv, D), dtype,
        functools.partial(plan, B, H, Hkv, Sq, Skv, D, Dv), (Dv,))


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the kernel reads the 4-D ``t`` in place: the head dim
    contiguous, every other stride a multiple of 16 bytes (or its extent
    1), and the start 16-byte aligned.  Written out: it runs three times a
    call."""
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, n3 = t.shape
    return ((s3 == 1 or n3 == 1) and not t.data_ptr() % 16
            and (n0 == 1 or (s0 > 0 and not s0 % 8))
            and (n1 == 1 or (s1 > 0 and not s1 % 8))
            and (n2 == 1 or (s2 > 0 and not s2 % 8)))


def _padded(t: torch.Tensor) -> torch.Tensor:
    r = t.shape[-1] % 8
    return (t if r == 0 else F.pad(t, (0, 8 - r))).contiguous()


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when ``tma_ready``, else a contiguous copy with the head
    dim zero-padded to a multiple of 8 (16 bytes; a narrow Dv under
    DEGRADED_REDUCED, such as 126): zero lanes add nothing to q.k, and the
    output lanes they make are sliced away."""
    return t if tma_ready(t) else _padded(t)


def _launch(q, k, v, *, causal, window, softcap, scale, kv_len,
            lane_fault, knobs):
    """The kernel on q, k, v in (B, H, S, D) order, any strides; the
    output in (B, S, H, Dv) memory, returned as a (B, H, S, Dv) view."""
    key = (q.shape, k.shape, v.shape, q.stride(), k.stride(),
           v.stride(), q.dtype, k.dtype, v.dtype, q.device, k.device,
           v.device, causal, window, softcap, scale, kv_len, lane_fault,
           tuning.current_plan_key(),
           tuple(sorted(knobs.items())) if knobs else None)
    call = _CALLS.get(key)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if call is None or (qp | kp | vp) % 16:
        return _launch_checked(q, k, v, key, causal=causal, window=window,
                               softcap=softcap, scale=scale, kv_len=kv_len,
                               lane_fault=lane_fault, knobs=knobs)
    tail, shape, Dv, mask, record = call
    out = torch.empty(shape, dtype=torch.bfloat16, device=q.device)
    lib = _build.load(_NAME, _PROTOTYPES)
    rc = lib.flash_attention_fwd(_HEAD.pack(
        qp, kp, vp, out.data_ptr(), mask,
        torch._C._cuda_getCurrentRawStream(q.device.index)) + tail)
    _build.check(lib, _NAME, rc)
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.plans[record] += 1
    o = out.transpose(1, 2)
    return o if shape[3] == Dv else o[..., :Dv]


def _launch_checked(q, k, v, key, *, causal, window, softcap, scale, kv_len,
                    lane_fault, knobs):
    # checks first, messages only on failure
    bf = torch.bfloat16
    if not (q.dtype == bf and k.dtype == bf and v.dtype == bf
            and q.dim() == 4 and k.dim() == 4 and v.dim() == 4
            and k.device == q.device and v.device == q.device):
        raise ValueError(
            "flash_attention: q, k, v must be 4-D bfloat16 on one device; "
            "got " + ", ".join(f"{t.dtype} {t.dim()}-D on {t.device}"
                               for t in (q, k, v)))
    B, H, Sq, D = q.shape
    _, Hkv, Skv, Dv = v.shape
    kshape = (B, Hkv, Skv, D)
    if k.shape != kshape or v.shape[:3] != kshape[:3]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not agree")
    # q and k share one head-dim width: both are copied if either must be
    if tma_ready(q) and tma_ready(k):
        qk, kk = q, k
    else:
        qk, kk = _padded(q), _padded(k)
    vk = tma_operand(v)
    Dp, Dvp = qk.shape[3], vk.shape[3]
    p = (plan(B, H, Hkv, Sq, Skv, Dp, Dvp, **knobs) if knobs else
         resolve(B, H, Hkv, Sq, Skv, D, Dv))
    record = ((B, Sq, Skv, H, Hkv, D, Dv),
              tuple(sorted(p.knobs().items())))
    # the output in the model's (B, S, H, Dv) order, its rows whole pairs
    # (``dvo`` in csrc/flash_attention.cu)
    shape = (B, Sq, H, Dvp + Dvp % 2)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, Dv, q.device)
    mask = mask.data_ptr() if mask is not None else 0
    qs, ks, vs = qk.stride(), kk.stride(), vk.stride()
    tail = _TAIL.pack(
        *qs[:3], *ks[:3], *vs[:3],
        B, H, Hkv, Sq, Skv, Dp, Dvp, Dv, min(kv_len or Skv, Skv),
        int(causal), int(window or 0), p.nwg, p.stages, p.grid, kind,
        _HEAD.size + _TAIL.size, scale or 1.0 / D ** 0.5,
        float(softcap or 0.0), value, gain)
    if qk is q and kk is k and vk is v:
        if len(_CALLS) >= _CALLS_KEEP:
            _CALLS.clear()
        _CALLS[key] = (tail, shape, Dv, mask, record)
    out = torch.empty(shape, dtype=bf, device=q.device)
    lib = _build.load(_NAME, _PROTOTYPES)
    rc = lib.flash_attention_fwd(_HEAD.pack(
        qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), out.data_ptr(), mask,
        torch._C._cuda_getCurrentRawStream(q.device.index)) + tail)
    _build.check(lib, _NAME, rc)
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.plans[record] += 1
    o = out.transpose(1, 2)
    return o if shape[3] == Dv else o[..., :Dv]


def smem_bytes(nwg: int, kd: int, vb: int, stages: int) -> int:
    """The compiled kernel's own shared-memory size (needs the CUDA build),
    to hold ``ring_bytes`` against."""
    return _build.load(_NAME, _PROTOTYPES).flash_attention_smem_bytes(
        nwg, kd, vb, stages)


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: float = 0.0,
                         kv_len: int = 0, bq: int = 128, bk: int = 128,
                         lane_fault=None,
                         knobs: Optional[Dict[str, int]] = None):
    """q (B, H, Sq, D); k (B, Hkv, Skv, D); v (B, Hkv, Skv, Dv).  The output
    width is ``v.shape[3]`` (narrow under DEGRADED_REDUCED).

    CUDA tensors: the Hopper kernel on q's device and its current stream,
    bf16 only, any Sq and Skv, any strides
    (``bq``/``bk`` shape only the plain version), launched with ``knobs``
    ({nwg, stages, per_sm}: explicit knobs win, ValueError if the kernel
    does not take them) or the ``resolve``d plan; the output is a (B, H,
    Sq, Dv) view of a (B, Sq, H, Dv) tensor.  CPU tensors: the plain
    blocked version, Sq % bq == Skv % bk == 0."""
    if q.device.type == "cuda":
        with torch.cuda.device(q.device):
            return _launch(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, kv_len=kv_len,
                           lane_fault=lane_fault, knobs=knobs)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return attention_ref_blocked(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale, kv_len=kv_len,
                                 bq=bq, bk=bk, lane_fault=lane_fault)


flash_attention_bhsd.launches = 0
flash_attention_bhsd.plans = collections.Counter()
