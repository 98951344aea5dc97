"""The chunk-parallel scans of the port: their plain versions and plans.

The Hopper WKV and SSD kernels run in three phases: chunk state, state
pass, chunk scan (``csrc/rwkv6_wkv.cu``, ``csrc/mamba2_ssd.cu``).  Their
plain PyTorch versions, ``wkv6_ref_state_passing`` and
``ssd_ref_state_passing``, are held here at float32 against the blocked
replicas, the token-by-token scans and the reference's Pallas kernels in
interpret mode, on the same numpy inputs.  The kernels themselves run only
on the card (``chip_smoke.py``).  ``plan`` (grids, group size, scratch and
shared memory) is plain Python, checked here at the serving shapes, B = 4,
S = 4096, L = 7 and the smoke widths.

Tolerances, float32 against float32 (the same algorithms in other
summation orders): the WKV 2e-5 absolute and 1e-5 of the largest reference
magnitude, the SSD 2e-4 absolute and 2e-3 relative, as in
``test_torch_rwkv6_scan.py`` and ``test_torch_mamba2_scan.py``.  Inputs
lie inside each scan's domain: lw in [-4, -1e-4]; dt = softplus(.) > 0,
A < 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.mamba2_scan as ref_m
import repro.kernels.rwkv6_scan as ref_w

import repro_torch.kernels.mamba2_scan as pt_m
import repro_torch.kernels.rwkv6_scan as pt_w
from repro_torch.configs import get_config
from repro_torch.kernels.mamba2_scan import kernel as ssd_kernel
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.models.mamba2 import dims as mamba2_dims

WKV_F32 = (2e-5, 1e-5)
SSD_F32 = (2e-4, 2e-3)
SM_COUNT = 132            # H100 SXM
SMEM_BLOCK = 232_448      # a block's dynamic shared memory
SMEM_SM = 233_472         # an SM's, 1 KB of it kept a block


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    d = np.abs(got - want).max()
    assert d <= tol[0] and d <= tol[1] * max(np.abs(want).max(), 1.0), d


def _wkv_inputs(B, S, H, K, seed, lw_range=(-4.0, -1e-4)):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 0.3, size=(B, S, H, K))
    k = rng.normal(0, 0.3, size=(B, S, H, K))
    v = rng.normal(0, 0.5, size=(B, S, H, K))
    lw = rng.uniform(*lw_range, size=(B, S, H, K))
    u = rng.normal(0, 0.5, size=(H, K))
    return tuple(a.astype(np.float32) for a in (r, k, v, lw, u))


def _ssd_inputs(B, S, H, P, N, seed, dt_range=None, a_max=2.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    if dt_range is None:
        dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, size=(B, S, H))))
    else:
        dt = rng.uniform(*dt_range, size=(B, S, H))
    A = -np.linspace(0.3, a_max, H)
    Bm = rng.normal(size=(B, S, N)) * 0.5
    C = rng.normal(size=(B, S, N)) * 0.5
    return tuple(a.astype(np.float32) for a in (x, dt, A, Bm, C))


def _jx(args):
    return tuple(jnp.asarray(a) for a in args)


def _pt(args):
    return tuple(torch.from_numpy(a) for a in args)


# (S, chunk, group): 1, 2, 7 and 32 chunks; groups of 2 and 4 chunks (the
# last group short); a ragged S that the op pads
WKV_CASES = [(16, 16, 1), (32, 16, 1), (56, 8, 1), (512, 16, 1),
             (56, 8, 2), (112, 16, 4), (45, 16, 1)]


@pytest.mark.parametrize("S,chunk,group", WKV_CASES,
                         ids=[f"S{s}-L{c}-G{g}" for s, c, g in WKV_CASES])
def test_wkv_state_passing_matches_blocked_scan_and_reference(S, chunk,
                                                              group):
    args = _wkv_inputs(1, S, 2, 16, seed=S + group)
    t = _pt(args)
    L = min(chunk, S)
    pad = -S % L
    tp = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
               for a in t[:4]) + (t[4],)
    o, state = pt_w.wkv6_ref_state_passing(*tp, chunk=chunk, group=group)
    o = o[:, :S]
    blocked_o, blocked_state = pt_w.wkv6_ref_blocked(*tp, chunk=chunk)
    _close(o, blocked_o[:, :S], WKV_F32)
    _close(state, blocked_state, WKV_F32)
    scan_o, scan_state = ref_w.wkv6_scan_ref(*_jx(args))
    _close(o, scan_o, WKV_F32)
    _close(state, scan_state, WKV_F32)
    want = ref_w.wkv6(*_jx(args), route="interpret", chunk=chunk)
    _close(o, want, WKV_F32)
    # the port's INTERPRET route pads and runs the same replica
    _close(pt_w.wkv6(*t, route="interpret", chunk=chunk), want, WKV_F32)


def test_wkv_state_passing_at_the_clamp_bound():
    """lw = -4 on every token: exp(-la) reaches e^64 at chunk 16; the
    groups' decays exp(sum la_L) reach e^-256 and e^-512."""
    args = _wkv_inputs(1, 128, 2, 16, seed=9, lw_range=(-4.0, -4.0))
    t = _pt(args)
    scan_o, scan_state = ref_w.wkv6_scan_ref(*_jx(args))
    want = ref_w.wkv6(*_jx(args), route="interpret", chunk=16)
    for group in (1, 4, 8):
        o, state = pt_w.wkv6_ref_state_passing(*t, chunk=16, group=group)
        _close(o, scan_o, WKV_F32)
        _close(state, scan_state, WKV_F32)
        _close(o, want, WKV_F32)


# (S, chunk): 1, 2, 7 and 32 chunks; a ragged S that the op pads
SSD_CASES = [(16, 16), (256, 128), (112, 16), (512, 16), (200, 128)]


@pytest.mark.parametrize("S,chunk", SSD_CASES,
                         ids=[f"S{s}-L{c}" for s, c in SSD_CASES])
def test_ssd_state_passing_matches_blocked_scan_and_reference(S, chunk):
    args = _ssd_inputs(1, S, 3, 16, 8, seed=S)
    t = _pt(args)
    L = min(chunk, S)
    pad = -S % L
    x = torch.nn.functional.pad(t[0], (0, 0, 0, 0, 0, pad))
    dt, Bm, C = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                 for a in (t[1], t[3], t[4]))
    y, state = pt_m.ssd_ref_state_passing(x, dt, t[2], Bm, C, chunk=chunk)
    y = y[:, :S]
    blocked_y, blocked_state = pt_m.ssd_ref_blocked(x, dt, t[2], Bm, C,
                                                    chunk=chunk)
    _close(y, blocked_y[:, :S], SSD_F32)
    _close(state, blocked_state, SSD_F32)
    scan_y, scan_state = ref_m.ssd_scan_ref(*_jx(args))
    _close(y, scan_y, SSD_F32)
    _close(state, scan_state, SSD_F32)
    want = ref_m.ssd(*_jx(args), route="interpret", chunk=chunk)
    _close(y, want, SSD_F32)
    _close(pt_m.ssd(*t, route="interpret", chunk=chunk), want, SSD_F32)


def test_ssd_state_passing_where_a_chunk_decays_past_e88():
    """Chunk 128 with A down to -16: a chunk's decay passes e^88, where the
    reference's ``ssd_chunked`` gives NaN above the diagonal; the replica
    selects the triangle before the exponent and equals the scan."""
    args = _ssd_inputs(1, 256, 4, 16, 8, seed=7, dt_range=(0.05, 1.0),
                       a_max=16.0)
    y, state = pt_m.ssd_ref_state_passing(*_pt(args), chunk=128)
    scan_y, scan_state = ref_m.ssd_scan_ref(*_jx(args))
    _close(y, scan_y, SSD_F32)
    _close(state, scan_state, SSD_F32)
    blocked_y, _ = pt_m.ssd_ref_blocked(*_pt(args), chunk=128)
    _close(y, blocked_y.numpy(), SSD_F32)


# ------------------------------------------------------------------ plans
RWKV = get_config("rwkv6-1.6b")
ZAMBA = get_config("zamba2-1.2b")
RWKV_SMOKE = RWKV.reduced()
ZAMBA_SMOKE = ZAMBA.reduced()
# (B, S, H, L) as the ops call the kernels; (G, groups) for the WKV
WKV_PLANS = {
    "serving": ((1, 512, RWKV.num_heads, 16), (2, 16)),
    "B4": ((4, 512, RWKV.num_heads, 16), (8, 4)),
    "S4096": ((1, 4096, RWKV.num_heads, 16), (16, 16)),
    "L7": ((1, 7, RWKV.num_heads, 7), (1, 1)),
    "smoke": ((1, 64, RWKV_SMOKE.num_heads, 8), (1, 8)),
}
ZH, ZH_SMOKE = mamba2_dims(ZAMBA)[1], mamba2_dims(ZAMBA_SMOKE)[1]
SSD_PLANS = {
    "serving": (1, 384, ZH, 128),
    "B4": (4, 384, ZH, 128),
    "S4096": (1, 4096, ZH, 128),
    "L7": (1, 7, ZH, 7),
    "smoke": (1, 64, ZH_SMOKE, 16),
}


@pytest.mark.parametrize("case", list(WKV_PLANS))
def test_wkv_plan(case):
    (B, S, H, L), (G, ng) = WKV_PLANS[case]
    p = wkv_kernel.plan(B, S, H, L)
    nc = S // L
    assert (p.chunks, p.group, p.groups) == (nc, G, ng)
    assert p.groups == -(-nc // p.group)
    # G is the largest power of two that keeps MIN_GROUPS groups, or 1
    items = B * H * p.groups
    assert items >= wkv_kernel.MIN_GROUPS or p.group == 1
    assert 2 * p.group > nc or \
        B * H * -(-nc // (2 * p.group)) < wkv_kernel.MIN_GROUPS
    assert p.grids == (items, 8 * B * H, items)
    assert p.scratch == items * (64 * 64 + 64) * 4
    assert p.scratch < 17 << 20     # inside the 50 MB L2
    # four chunk-scan blocks a SM
    assert p.smem[0] <= SMEM_BLOCK and 4 * (p.smem[1] + 1024) <= SMEM_SM
    if case == "serving":
        # every phase that does a chunk's products fills the card at B = 1
        assert min(p.grids[0], p.grids[2]) >= SM_COUNT


@pytest.mark.parametrize("case", list(SSD_PLANS))
def test_ssd_plan(case):
    B, S, H, L = SSD_PLANS[case]
    p = ssd_kernel.plan(B, S, H, L)
    nc, tiles = S // L, -(-L // 64)
    assert (p.chunks, p.tiles, p.group) == (nc, tiles, 1)
    assert p.grids == (B * H * nc, 8 * B * H, B * H * nc * tiles)
    assert p.scratch == 4 * (B * H * nc * 64 * 64 + B * nc * 128 * 128
                             + B * H * nc)
    # three chunk-scan blocks a SM, and three chunk-state blocks
    assert 3 * (p.smem[1] + 1024) <= SMEM_SM
    assert 3 * (p.smem[0] + 1024) <= SMEM_SM
    if case == "serving":
        assert min(p.grids[0], p.grids[2]) >= SM_COUNT


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="no plan"):
        wkv_kernel.plan(1, 64, 2, 32)          # L > 16
    with pytest.raises(ValueError, match="no plan"):
        wkv_kernel.plan(1, 60, 2, 16)          # S % L
    with pytest.raises(ValueError, match="no plan"):
        ssd_kernel.plan(1, 512, 2, 256)        # L > 128
    with pytest.raises(ValueError, match="no plan"):
        ssd_kernel.plan(1, 200, 2, 128)        # S % L


def test_ssd_reads_the_models_views_in_place():
    """x, B and C as ``models/mamba2.py`` cuts them from one xbc tensor
    are read through their strides (no copy); an operand whose rows are
    not 16-byte aligned, or a narrow one, is copied and zero-padded."""
    H, P, N = ZH, ZAMBA.ssm.head_dim, ZAMBA.ssm.state_dim
    xbc = torch.zeros((2, 384, H * P + 2 * N), dtype=torch.bfloat16)
    xs, Bv, Cv = torch.split(xbc, [H * P, N, N], dim=-1)
    xs = xs.reshape(2, 384, H, P)
    assert not xs.is_contiguous()
    for t in (xs, Bv, Cv):
        assert ssd_kernel.strided_ready(t)
        assert ssd_kernel._operand(t) is t
    odd = torch.zeros((2, 384, N + 4), dtype=torch.bfloat16)[..., 4:]
    assert not ssd_kernel.strided_ready(odd)
    copied = ssd_kernel._operand(odd)
    assert copied.is_contiguous() and torch.equal(copied, odd)
    narrow = ssd_kernel._operand(torch.ones((1, 8, 2, 40),
                                            dtype=torch.bfloat16))
    assert narrow.shape == (1, 8, 2, 64) and narrow[..., 40:].eq(0).all()
