"""Chunked Mamba2 SSD on Hopper: the wrapper of ``csrc/mamba2_ssd.cu``.

Replaces the Pallas kernel ``ssd_chunked_pallas``
(src/repro/kernels/mamba2_scan/kernel.py).  The CUDA side runs three
phases (chunk state with the shared C B^T, state pass, chunk scan) in one
call; ``plan`` is their launch plan in plain Python, the same on every
device.  On a CUDA tensor the wrapper checks its inputs, reads x, B and C
through their strides (the model's views of one projection: no copy when
P = N = 64 and the rows are 16-byte aligned; otherwise a zero-padded
contiguous copy), allocates y, (when asked) the final state and the plan's
scratch, and launches, or raises; on a CPU tensor it runs the plain version
of the three phases, ``ssd_ref_state_passing``.
``ssd_chunked_cuda.launches`` counts CUDA calls (one a call, three kernels)
and nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_scan.ref import ssd_ref_state_passing

_NAME = "mamba2_ssd"
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_PROTOTYPES = {
    "mamba2_ssd_fwd": (
        _P, _P, _P, _P, _P, _P, _P,          # x, dt, A, B, C, y, state
        _P, _LL,                             # scratch, its bytes
        _I, _I, _I, _I,                      # B, S, H, L
        _LL, _LL, _LL, _LL, _LL, _LL, _LL,   # x (b, s, h), B (b, s), C (b, s)
        _I, _P, _F, _F,                      # fault kind, mask, value, gain
        _P),                                 # stream
    "mamba2_ssd_plan": (_I, _I, _I, _I, _P),  # B, S, H, L, out[8]
}
WIDTH = 64   # the kernel's N and P
LMAX = 128   # the kernel's longest chunk
TILE = 64    # rows of y a chunk-scan block
PASS_THREADS = 128   # a block of the state pass, four entries a thread


@dataclasses.dataclass(frozen=True)
class Plan:
    chunks: int                    # S / L
    tiles: int                     # 64-row tiles of y a chunk
    group: int                     # chunks a work item walks: always 1
    grids: Tuple[int, int, int]    # blocks: chunk state, state pass, scan
    scratch: int                   # bytes: U a (b, h, chunk), C B^T a
                                   # (b, chunk), d a (b, h, chunk), f32
    smem: Tuple[int, int]          # dynamic shared memory: state, scan


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, L: int) -> Plan:
    """The launch plan of one call (``make_plan`` in csrc/mamba2_ssd.cu).
    A chunk of up to 128 tokens is already a work item as large as its x
    (its f32 state is 16 KB, its x 16 KB in bf16), so chunks are not
    grouped: one chunk-state block per (b, h, chunk), which also computes
    the rows h, h + H, ... of the (b, chunk)'s C B^T, and one chunk-scan
    block per (b, h, chunk, 64-row tile)."""
    if min(B, S, H, L) < 1 or L > LMAX or S % L:
        raise ValueError(f"mamba2_ssd: no plan for B={B} S={S} H={H} L={L}")
    nc = S // L
    tiles = -(-L // TILE)
    scratch = 4 * (B * H * nc * WIDTH * WIDTH + B * nc * LMAX * LMAX
                   + B * H * nc)
    # B^T, xdt exp(tot - cum), dt and cum
    state_smem = 4 * (WIDTH * (LMAX + 4) + LMAX * (WIDTH + 8) + 2 * LMAX)
    # the tile's rows of W dt and S_in (f32), x and the tile's C rows
    # (bf16), dt and cum; unpadded (swizzled), three blocks a SM
    scan_smem = (4 * (TILE * LMAX + WIDTH * WIDTH + 2 * LMAX)
                 + 2 * (LMAX * WIDTH + TILE * WIDTH))
    return Plan(chunks=nc, tiles=tiles, group=1,
                grids=(B * H * nc, WIDTH * WIDTH // 4 // PASS_THREADS * B * H,
                       B * H * nc * tiles),
                scratch=scratch, smem=(state_smem, scan_smem))


def c_plan(B: int, S: int, H: int, L: int) -> Plan:
    """The plan as the compiled library computes it (``mamba2_ssd_plan``),
    in ``Plan``'s fields; for checking ``plan`` on the card."""
    out = (ctypes.c_longlong * 8)()
    lib = _build.load(_NAME, _PROTOTYPES)
    _build.check(lib, _NAME, lib.mamba2_ssd_plan(B, S, H, L, out))
    nc, tiles, g1, g2, g3, scratch, sm1, sm3 = out
    return Plan(chunks=nc, tiles=tiles, group=1, grids=(g1, g2, g3),
                scratch=scratch, smem=(sm1, sm3))


def strided_ready(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` (x (B, S, H, 64) or B/C (B, S, 64))
    in place: the last dim 64 and contiguous, every other stride (of an
    extent above 1) positive and a multiple of 8 elements (16 bytes), the
    start 16-byte aligned."""
    return (t.shape[-1] == WIDTH and t.stride(-1) == 1
            and not t.data_ptr() % 16
            and all(n == 1 or (s > 0 and not s % 8)
                    for n, s in zip(t.shape[:-1], t.stride()[:-1])))


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when ``strided_ready``, else a contiguous copy with the
    last dim zero-padded to 64: zero B/C columns and zero x lanes add
    nothing, and the y lanes they make are sliced away."""
    if strided_ready(t):
        return t
    if t.shape[-1] != WIDTH:
        t = F.pad(t, (0, WIDTH - t.shape[-1]))
    return t.contiguous()


def _launch(x, dt, A, B_, C, *, L, lane_fault, with_state):
    # the checks' messages are built only on failure: this runs once a
    # layer of every prefill
    for name, t, dtype in (("x", x, torch.bfloat16), ("B_", B_, torch.bfloat16),
                           ("C", C, torch.bfloat16), ("dt", dt, torch.float32),
                           ("A", A, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"mamba2_ssd: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"mamba2_ssd: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 4:
        raise ValueError("mamba2_ssd: x must be (B, S, H, P)")
    Bt, S, H, P = x.shape
    N = B_.shape[-1]
    if not (dt.shape == (Bt, S, H) and A.shape == (H,)
            and B_.shape == (Bt, S, N) and C.shape == (Bt, S, N)):
        raise ValueError(
            f"mamba2_ssd: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"A {tuple(A.shape)} B {tuple(B_.shape)} C {tuple(C.shape)} "
            "do not agree")
    if P > WIDTH or N > WIDTH:
        raise ValueError(f"mamba2_ssd: P={P}, N={N} exceed the kernel's "
                         f"{WIDTH}")
    if not (1 <= L <= LMAX and S % L == 0):
        raise ValueError(f"mamba2_ssd: chunk L={L} must be in [1, {LMAX}] "
                         f"and divide S={S}")
    xk, Bk, Ck = _operand(x), _operand(B_), _operand(C)
    dtc, Ac = dt.contiguous(), A.contiguous()
    p = plan(Bt, S, H, L)
    y = torch.empty((Bt, S, H, WIDTH), dtype=x.dtype, device=x.device)
    state = (torch.empty((Bt, H, WIDTH, WIDTH), dtype=torch.float32,
                         device=x.device) if with_state else None)
    scratch = torch.empty(p.scratch // 4, dtype=torch.float32,
                          device=x.device)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, P, x.device)
    if mask is not None and mask.numel() < WIDTH // 32:
        mask = F.pad(mask, (0, WIDTH // 32 - mask.numel()))  # padded lanes
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mamba2_ssd_fwd(
        xk.data_ptr(), dtc.data_ptr(), Ac.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None, scratch.data_ptr(),
        p.scratch, Bt, S, H, L, *xk.stride()[:3], *Bk.stride()[:2],
        *Ck.stride()[:2], kind,
        mask.data_ptr() if mask is not None else None, value, gain, stream)
    _build.check(lib, _NAME, rc)
    ssd_chunked_cuda.launches += 1
    y = y if P == WIDTH else y[..., :P]
    if state is not None and (N, P) != (WIDTH, WIDTH):
        state = state[:, :, :N, :P]
    return y, state


def ssd_chunked_cuda(x, dt, A, B_, C, *, chunk: int = 128, lane_fault=None,
                     with_state: bool = False):
    """x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B_/C (B,S,N) -> (y
    (B,S,H,P) in x's dtype, the final state (B,H,N,P) f32 when
    ``with_state`` else None).  S must be a multiple of ``L = min(chunk,
    S)`` (the op pads).

    CUDA tensors: the Hopper kernel on x's device and its current
    stream; x, B_ and C bf16 (any strides with
    the last dim contiguous), P and N up to 64, L up to 128.  CPU tensors:
    its plain version, ``ssd_ref_state_passing``."""
    L = min(chunk, x.shape[1])
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            return _launch(x, dt, A, B_, C, L=L, lane_fault=lane_fault,
                           with_state=with_state)
    if x.device.type != "cpu":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    y, state = ssd_ref_state_passing(x, dt, A, B_, C, chunk=L,
                                     lane_fault=lane_fault)
    return y, (state if with_state else None)


ssd_chunked_cuda.launches = 0
