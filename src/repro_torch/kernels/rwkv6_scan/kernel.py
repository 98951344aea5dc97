"""Chunked RWKV-6 WKV on Hopper: the wrapper of ``csrc/rwkv6_wkv.cu``.

Replaces the Pallas kernel ``wkv6_chunked_pallas``
(src/repro/kernels/rwkv6_scan/kernel.py).  The CUDA side runs three
phases (chunk state, state pass, chunk scan) in one call; ``plan`` is their
launch plan in plain Python, the same on every device.  On a CUDA tensor
the wrapper checks its inputs, zero-pads K and V to the kernel's 64,
allocates o, (when asked) the final state and the plan's scratch, and
launches, or raises; on a CPU tensor it runs the plain version of the
three phases, ``wkv6_ref_state_passing``.  ``wkv6_chunked_cuda.launches``
counts CUDA calls (one a call, three kernels) and nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref_state_passing

_NAME = "rwkv6_wkv"
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_PROTOTYPES = {
    "rwkv6_wkv_fwd": (
        _P, _P, _P, _P, _P, _P, _P,          # r, k, v, lw, u, o, state
        _P, _LL,                             # scratch, its bytes
        _I, _I, _I, _I,                      # B, S, H, L
        _I, _P, _F, _F,                      # fault kind, mask, value, gain
        _P),                                 # stream
    "rwkv6_wkv_plan": (_I, _I, _I, _I, _P),  # B, S, H, L, out[9]
}
WIDTH = 64   # the kernel's K and V
# The longest chunk: the factorization takes exp(-la) with |la| up to
# L * 4 (lw >= -4), which stays inside f32 (e^64 < e^88) only for L <= 16.
LMAX = 16
THREADS = 256             # a block of the chunk phases
PASS_THREADS = 128        # a block of the state pass, four entries a thread
MIN_GROUPS = 512          # about a wave of phase-3 blocks, 4 a SM


@dataclasses.dataclass(frozen=True)
class Plan:
    chunks: int                    # S / L
    group: int                     # chunks a phase-1/3 work item walks (G)
    groups: int                    # work items per (b, h)
    grids: Tuple[int, int, int]    # blocks: chunk state, state pass, scan
    scratch: int                   # bytes: U (K x V) and d (K) a group, f32
    smem: Tuple[int, int]          # dynamic shared memory: state, scan


def chunk_smem() -> int:
    """``Chunk`` in csrc/rwkv6_wkv.cu: k, lw, v and kscale (16 x 64 f32
    each) and the chunk's decay (64 f32)."""
    return 4 * (4 * LMAX * WIDTH + WIDTH)


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, L: int) -> Plan:
    """The launch plan of one call (``make_plan`` in csrc/rwkv6_wkv.cu).
    G, the chunks a work item of phases 1 and 3 walks, stays 1 while the
    (b, h, chunk) items number under 1024, and is otherwise the largest
    power of two that keeps ``MIN_GROUPS`` or more groups: about a wave of
    chunk-scan blocks at four a SM, and a scratch of one f32 (K, V) state
    and K-vector a group that stays under 17 MB, inside the H100's 50 MB
    L2."""
    if min(B, S, H, L) < 1 or L > LMAX or S % L:
        raise ValueError(f"rwkv6_wkv: no plan for B={B} S={S} H={H} L={L}")
    nc = S // L
    G = 1
    while 2 * G <= nc and B * H * -(-nc // (2 * G)) >= MIN_GROUPS:
        G *= 2
    ng = -(-nc // G)
    items = B * H * ng
    # [scores | qexp], [v ; S], kexp, kscale, r, k, lw, exp(la_L), the
    # bonus, u; row strides padded as in csrc/rwkv6_wkv.cu
    scan_smem = 4 * (LMAX * (LMAX + WIDTH + 20) + (LMAX + WIDTH) * (WIDTH + 8)
                     + LMAX * (WIDTH + 4) + LMAX * (WIDTH + 8)
                     + 3 * LMAX * WIDTH + WIDTH + LMAX + WIDTH)
    return Plan(chunks=nc, group=G, groups=ng,
                grids=(items, WIDTH * WIDTH // 4 // PASS_THREADS * B * H,
                       items),
                scratch=items * (WIDTH * WIDTH + WIDTH) * 4,
                smem=(chunk_smem(), scan_smem))


def c_plan(B: int, S: int, H: int, L: int) -> Plan:
    """The plan as the compiled library computes it (``rwkv6_wkv_plan``),
    in ``Plan``'s fields; for checking ``plan`` on the card."""
    out = (ctypes.c_longlong * 9)()
    lib = _build.load(_NAME, _PROTOTYPES)
    _build.check(lib, _NAME, lib.rwkv6_wkv_plan(B, S, H, L, out))
    nc, G, ng, g1, g2, g3, scratch, sm1, sm3 = out
    return Plan(chunks=nc, group=G, groups=ng, grids=(g1, g2, g3),
                scratch=scratch, smem=(sm1, sm3))


def _pad_last(t, width):
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _launch(r, k, v, lw, u, *, L, lane_fault, with_state):
    # the checks' messages are built only on failure: this runs once a
    # layer of every prefill
    for name, t, dtype in (("r", r, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16),
                           ("lw", lw, torch.bfloat16), ("u", u, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"rwkv6_wkv: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"rwkv6_wkv: {name} is on {t.device}, r on "
                             f"{r.device}")
    if r.dim() != 4:
        raise ValueError("rwkv6_wkv: r must be (B, S, H, K)")
    Bt, S, H, K = r.shape
    V = v.shape[-1]
    if not (k.shape == r.shape and lw.shape == r.shape
            and v.shape == (Bt, S, H, V) and u.shape == (H, K)):
        raise ValueError(
            f"rwkv6_wkv: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} lw {tuple(lw.shape)} u {tuple(u.shape)} "
            "do not agree")
    if K > WIDTH or V > WIDTH:
        raise ValueError(f"rwkv6_wkv: K={K}, V={V} exceed the kernel's "
                         f"{WIDTH}")
    if not (1 <= L <= LMAX and S % L == 0):
        raise ValueError(f"rwkv6_wkv: chunk L={L} must be in [1, {LMAX}] "
                         f"and divide S={S}")
    # zero r/k channels (with lw = 0 and u = 0) and zero v lanes add
    # nothing; their outputs are sliced away
    rp, kp, vp, lwp = (_pad_last(t, WIDTH).contiguous()
                       for t in (r, k, v, lw))
    up = _pad_last(u, WIDTH).contiguous()
    if any(t.data_ptr() % 16 for t in (rp, kp, vp, lwp)):
        raise ValueError("rwkv6_wkv: inputs must be 16-byte aligned")
    p = plan(Bt, S, H, L)
    o = torch.empty((Bt, S, H, WIDTH), dtype=r.dtype, device=r.device)
    state = (torch.empty((Bt, H, WIDTH, WIDTH), dtype=torch.float32,
                         device=r.device) if with_state else None)
    scratch = torch.empty(p.scratch // 4, dtype=torch.float32,
                          device=r.device)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, V, r.device)
    if mask is not None and mask.numel() < WIDTH // 32:
        mask = F.pad(mask, (0, WIDTH // 32 - mask.numel()))  # padded lanes
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_wkv_fwd(
        rp.data_ptr(), kp.data_ptr(), vp.data_ptr(), lwp.data_ptr(),
        up.data_ptr(), o.data_ptr(),
        state.data_ptr() if state is not None else None, scratch.data_ptr(),
        p.scratch, Bt, S, H, L, kind,
        mask.data_ptr() if mask is not None else None, value, gain, stream)
    _build.check(lib, _NAME, rc)
    wkv6_chunked_cuda.launches += 1
    o = o if V == WIDTH else o[..., :V]
    if state is not None and (K, V) != (WIDTH, WIDTH):
        state = state[:, :, :K, :V]
    return o, state


def wkv6_chunked_cuda(r, k, v, lw, u, *, chunk: int = 16, lane_fault=None,
                      with_state: bool = False):
    """r/k/lw (B,S,H,K), v (B,S,H,V), u (H,K) f32 -> (o (B,S,H,V) in r's
    dtype, the final state (B,H,K,V) f32 when ``with_state`` else None).
    S must be a multiple of ``L = min(chunk, S)`` (the op pads).

    CUDA tensors: the Hopper kernel on r's device and its current
    stream; r, k, v and lw bf16, K and V up to
    64.  CPU tensors: its plain version, ``wkv6_ref_state_passing`` with
    the plan's group size.  On both, L up to 16."""
    L = min(chunk, r.shape[1])
    _build.require(L <= LMAX, f"rwkv6_wkv: chunk {chunk} exceeds {LMAX}: "
                   "the factorization leaves f32 range past it")
    if r.device.type == "cuda":
        with torch.cuda.device(r.device):
            return _launch(r, k, v, lw, u, L=L, lane_fault=lane_fault,
                           with_state=with_state)
    if r.device.type != "cpu":
        raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")
    o, state = wkv6_ref_state_passing(
        r, k, v, lw, u, chunk=L,
        group=plan(r.shape[0], r.shape[1], r.shape[2], L).group,
        lane_fault=lane_fault)
    return o, (state if with_state else None)


wkv6_chunked_cuda.launches = 0
