"""Gated MLP on Hopper: the wrapper of ``csrc/swiglu.cu``.

Replaces the Pallas kernel ``swiglu_pallas``
(src/repro/kernels/swiglu/kernel.py).  The TPU kernel keeps the (M, F)
hidden in VMEM; here it goes through the L2 once as bf16, between two
TMA + ``wgmma`` GEMMs (phase A: G = act(x @ w1) * (x @ w3); phase B:
y = G @ w2, its F axis cut into a fixed number of slices that a third
small kernel sums in order).  At decode the weights' bytes bound the call,
at prefill its operations.

``plan`` is the launch plan in plain Python, the same on every device:
tiles, slices, shared memory and grids from ``(M, D, F, Do,
row_independent)`` and, optionally, the tuned knobs (``nwg``, ``nsub``;
the ``swiglu_mlp`` hw space of ``kernels/tuning``).  The K tiling and the
slice count depend on the widths only, never on M or a knob, so a row's
bits do not depend on how many rows share the call or how.  ``resolve``
gives a CUDA call's plan: the tuning cache's entry where one is admissible
at the call's real Do (a row-independent call keeps one warpgroup a
block), else the default; once per call signature and plan key.  On a
CUDA tensor the wrapper pads the widths to the tile, allocates the output,
takes its scratch from a buffer kept per stream, and launches, or raises;
on a CPU tensor it runs the plain version, ``swiglu_ref_blocked``, with the
reference's tiles and no tuning lookup.
``swiglu_fused.launches`` counts one per call that launched the kernels;
``swiglu_fused.plans`` counts them by (shape, knobs).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.swiglu.ref import swiglu_ref_blocked

_NAME = "swiglu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROTOTYPES = {
    "swiglu_fwd": (
        _P, _P, _P, _P,                      # x, w1, w3, w2
        _P, _P, _P,                          # g, ws, out
        _I, _I, _I, _I,                      # M, D, F, Do
        _I, _I, _I, _I,                      # nwg, nsub, splits, act
        _I, _P, _F, _F, _I,                  # fault kind, mask, value, gain,
                                             # lanes
        _P),                                 # stream
    "swiglu_smem_bytes": (_I, _I),           # nwg, nsub (0: phase A)
}
ACTS = {"silu": 0, "gelu": 1}
TILE = 64                 # K per stage, columns per block, rows per warpgroup
BOX = TILE * TILE * 2     # one 64 x 64 bf16 box in shared memory
SM_COUNT = 132            # H100 SXM
SMEM_LIMIT = 232_448      # a Hopper block's dynamic shared memory


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def ring_bytes(nwg: int, nsub: int = 0) -> int:
    """Dynamic shared memory of a phase-A block (``nsub`` 0) or a phase-B
    block with ``nsub`` w2 tiles (``Ring`` in csrc/swiglu.cu): as many
    stages as fit in 200 KB, at most 12, each an x or G box per consumer
    warpgroup plus w1 and w3, or the w2 boxes; two mbarriers a stage; 1024
    bytes to align the swizzled boxes."""
    stage = (nwg + (nsub or 2)) * BOX
    stages = min(12, 200 * 1024 // stage)
    return stages * stage + 16 * stages + 1024


def split_count(D: int, F: int, Do: int) -> int:
    """Slices of F in phase B, from the widths alone: enough output tiles
    times slices to cover the SMs, at least 4 K tiles a slice, and no
    empty slice."""
    nkf, tiles = _ceil(F, TILE), _ceil(Do, TILE)
    s = max(1, min(nkf // 4, int(SM_COUNT / tiles + 0.5)))
    return _ceil(nkf, _ceil(nkf, s))


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str                     # the MMA path: one for every M
    nwg: int                      # consumer warpgroups a block
    nsub: int                     # 64-column w2 tiles a phase-B block
    bm: int                       # rows a block (64 each warpgroup)
    bk: int                       # K tile of both phases
    dims: Tuple[int, int, int]    # (D, F, Do) padded to the tile
    splits: int                   # slices of F in phase B
    k_per_split: int              # F tiles a slice
    smem: Tuple[int, int]         # dynamic shared memory, phase A and B
    grid_a: Tuple[int, int, int]
    grid_b: Tuple[int, int, int]  # z: the slices (summed by a 3rd kernel)

    def knobs(self) -> Dict[str, int]:
        """The tunable knobs this plan was made with."""
        return {"nwg": self.nwg, "nsub": self.nsub}


def _warpgroups(M: int, row_independent: bool) -> int:
    """64-row consumer warpgroups a block: one for decode and for every
    row-independent call, else 2 or 3, whichever pads M less (3 on a
    tie: taller blocks read the weights fewer times)."""
    if row_independent or M <= TILE:
        return 1
    return min((3, 2), key=lambda n: _ceil(M, TILE * n) * n)


@functools.lru_cache(maxsize=256)
def plan(M: int, D: int, F: int, Do: int, row_independent: bool = False, *,
         nwg: Optional[int] = None, nsub: Optional[int] = None) -> Plan:
    """The launch plan of one call.  Every M takes the same MMAs (m64n128k16
    in phase A, m64n64k16 in phase B, K in order 16 at a time) and the same
    slices; M and the knobs pick only how many rows and columns share a
    block, which changes no row's arithmetic.  A ``row_independent`` call
    keeps one warpgroup a block whatever its M.

    Knobs come both or neither, and must be ones the kernel takes:
    ``nwg`` 1-3 (1 for a row-independent call), ``nsub`` 2 only with
    ``nwg`` > 1 and a padded Do of whole 128s; anything else raises
    ValueError."""
    if min(M, D, F, Do) < 1:
        raise ValueError(f"swiglu: empty shape {(M, D, F, Do)}")
    Dp, Fp, Dop = (_ceil(n, TILE) * TILE for n in (D, F, Do))
    if (nwg, nsub) != (None, None) and not (
            nwg in (1, 2, 3) and nsub in (1, 2)
            and (nwg == 1 or not row_independent)
            and (nsub == 1 or (nwg > 1 and Dop % (2 * TILE) == 0))):
        raise ValueError(f"swiglu: knobs nwg={nwg} nsub={nsub} do not fit "
                         f"M={M} Do={Do} (row_independent="
                         f"{row_independent})")
    if nwg is None:
        nwg = _warpgroups(M, row_independent)
    bm = TILE * nwg
    mt = _ceil(M, bm)
    splits = split_count(D, F, Do)
    if nsub is None:
        # 128 columns a phase-B block where that still covers the SMs
        wide = (nwg > 1 and Dop % (2 * TILE) == 0
                and mt * Dop // (2 * TILE) * splits >= 0.9 * SM_COUNT)
        nsub = 2 if wide else 1
    return Plan(path="wgmma", nwg=nwg, nsub=nsub, bm=bm, bk=TILE,
                dims=(Dp, Fp, Dop), splits=splits,
                k_per_split=_ceil(Fp // TILE, splits),
                smem=(ring_bytes(nwg), ring_bytes(nwg, nsub)),
                grid_a=(mt, Fp // TILE, 1),
                grid_b=(mt, Dop // (TILE * nsub), splits))


def resolve(M: int, D: int, F: int, Do: int, row_independent: bool = False,
            dtype=torch.bfloat16) -> Plan:
    """The plan of a CUDA call: the tuning cache's ``swiglu_mlp`` hw entry
    for (M, D, F), the dtype and the active routing-plan key, where
    ``plan`` takes it at the call's real Do (a DEGRADED_REDUCED w2 can
    refuse it); else the default plan.  A ``row_independent`` call keeps
    one warpgroup a block whatever an entry says (``plan`` refuses more).
    Memoized until the cache changes."""
    return tuning.resolve_plan(
        "swiglu_mlp", (M, D, F), dtype,
        functools.partial(plan, M, D, F, Do, row_independent),
        (Do, row_independent))


# per (device, stream): the G and partials scratch of calls up to
# SCRATCH_KEEP bytes, reused in stream order (as PyTorch keeps a cuBLAS
# workspace a stream); larger calls allocate their own
SCRATCH_KEEP = 32 << 20
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch(device, stream: int, nbytes: int) -> torch.Tensor:
    if nbytes > SCRATCH_KEEP:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    buf = _SCRATCH.get((device.index, stream))
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                          device=device)
        _SCRATCH[(device.index, stream)] = buf
    return buf


def _pad(t, rows, cols):
    r, c = rows - t.shape[0], cols - t.shape[1]
    return t if r == 0 and c == 0 else F.pad(t, (0, c, 0, r))


def _launch(x, w1, w3, w2, *, act, lane_fault, row_independent, knobs):
    # checks first, messages only on failure: this runs once a layer
    ts = (x, w1, w3, w2)
    if not (all(t.dtype == torch.bfloat16 and t.dim() == 2 for t in ts)
            and w1.device == w3.device == w2.device == x.device):
        raise ValueError(
            "swiglu: x, w1, w3, w2 must be 2-D bfloat16 on one device; got "
            + ", ".join(f"{t.dtype} {t.dim()}-D on {t.device}" for t in ts))
    if act not in ACTS:
        raise ValueError(f"swiglu: unknown act {act!r}")
    M, D = x.shape
    Fd = w1.shape[1]
    Do = w2.shape[1]
    if not (M >= 1 and w1.shape == (D, Fd) and w3.shape == (D, Fd)
            and w2.shape[0] == Fd):
        raise ValueError(
            f"swiglu: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
            f"w3 {tuple(w3.shape)} w2 {tuple(w2.shape)} do not agree")
    p = (plan(M, D, Fd, Do, row_independent, **knobs) if knobs else
         resolve(M, D, Fd, Do, row_independent))
    Dp, Fp, Dop = p.dims
    # zero rows and columns add nothing (silu(0) * 0 = gelu(0) * 0 = 0) and
    # the padded output lanes are sliced away
    xp = _pad(x, M, Dp).contiguous()
    w1p, w3p = (_pad(w, Dp, Fp).contiguous() for w in (w1, w3))
    w2p = _pad(w2, Fp, Dop).contiguous()
    ptrs = [t.data_ptr() for t in (xp, w1p, w3p, w2p)]
    if any(ptr % 16 for ptr in ptrs):
        raise ValueError("swiglu: inputs must be 16-byte aligned")
    # scratch: G (M, Fp) bf16, then the f32 partials
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    g_bytes = 2 * M * Fp
    sliced = p.splits > 1
    g = _scratch(x.device, stream,
                 g_bytes + (4 * p.splits * M * Dop if sliced else 0)
                 ).data_ptr()
    out = torch.empty((M, Dop), dtype=torch.bfloat16, device=x.device)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, Do, x.device)
    lib = _build.load(_NAME, _PROTOTYPES)
    rc = lib.swiglu_fwd(
        *ptrs, g, g + g_bytes if sliced else None, out.data_ptr(), M, Dp, Fp,
        Dop, p.nwg, p.nsub, p.splits, ACTS[act], kind,
        mask.data_ptr() if mask is not None else None, value, gain, Do,
        stream)
    _build.check(lib, _NAME, rc)
    swiglu_fused.launches += 1
    swiglu_fused.plans[((M, D, Fd, Do, row_independent),
                        (("nsub", p.nsub), ("nwg", p.nwg)))] += 1
    return out if Dop == Do else out[:, :Do]


def smem_bytes(nwg: int, nsub: int = 0) -> int:
    """The compiled kernel's own ring size (needs the CUDA build), to hold
    ``ring_bytes`` against."""
    return _build.load(_NAME, _PROTOTYPES).swiglu_smem_bytes(nwg, nsub)


def swiglu_fused(x, w1, w3, w2, *, act: str = "silu", bm: int = 128,
                 bf: int = 512, bs: int = 128, lane_fault=None,
                 row_independent: bool = False,
                 knobs: Optional[Dict[str, int]] = None):
    """x (M, D); w1/w3 (D, F); w2 (F, Do) -> (M, Do).

    CUDA tensors: the Hopper kernels on x's device and its current
    stream, bf16 only, tiled by ``plan`` with
    ``knobs`` ({nwg, nsub}: explicit knobs win, ValueError if the kernel
    does not take them) or by the ``resolve``d plan (``bm`` / ``bf`` /
    ``bs`` shape only the plain version); any M.  CPU tensors: the plain
    blocked version."""
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            return _launch(x, w1, w3, w2, act=act, lane_fault=lane_fault,
                           row_independent=row_independent, knobs=knobs)
    if x.device.type != "cpu":
        raise ValueError(f"swiglu: unsupported device {x.device}")
    return swiglu_ref_blocked(x, w1, w3, w2, act=act, bm=bm, bf=bf, bs=bs,
                              lane_fault=lane_fault)


swiglu_fused.launches = 0
swiglu_fused.plans = collections.Counter()
