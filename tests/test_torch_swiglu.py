"""Fused SwiGLU of the port against the reference, on the CPU.

The same numpy inputs go through the reference (SW oracle, Pallas kernel
in interpret mode) and the port (SW oracle, INTERPRET replica, HW wrapper,
which on a CPU tensor runs the kernel's plain blocked version).  The
Hopper kernel itself runs only on the card (``chip_smoke.py``).

Tolerances: float32 against float32, 1e-5 absolute and relative (float32
rounding of sums over F <= 1024 terms of O(0.1) values, in other orders);
bfloat16 holds the op's ``tol`` of 2e-2 absolute and 2e-2 of the largest
reference magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swiglu import swiglu as ref_swiglu
from repro.kernels.swiglu import swiglu_flops as ref_flops
from repro.viscosity import lanefault as ref_lf

from repro_torch.kernels.swiglu import (SWIGLU, swiglu, swiglu_flops,
                                        swiglu_ref)
from repro_torch.viscosity import lanefault as pt_lf

F32_TOL = 1e-5
BF16_ABS, BF16_REL = 2e-2, 2e-2


@pytest.fixture(autouse=True)
def _clean_registries():
    ref_lf.reset()
    pt_lf.reset()
    yield
    ref_lf.reset()
    pt_lf.reset()


def _inputs(M, D, F, Do=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w1 = (rng.normal(size=(D, F)) * 0.1).astype(np.float32)
    w3 = (rng.normal(size=(D, F)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(F, Do or D)) * 0.1).astype(np.float32)
    return x, w1, w3, w2


def _ref(args, dtype, route, **kw):
    return np.asarray(ref_swiglu(*(jnp.asarray(a, dtype) for a in args),
                                 route=route, **kw), np.float32)


def _pt(args, dtype, route, **kw):
    return swiglu(*(torch.from_numpy(a).to(dtype) for a in args),
                  route=route, **kw).float().numpy()


@pytest.mark.parametrize("M", [1, 3, 8, 130])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_f32_matches_reference(M, act):
    args = _inputs(M, 64, 640)
    want = _ref(args, jnp.float32, "interpret", act=act)
    for route in ("hw", "interpret"):
        np.testing.assert_allclose(_pt(args, torch.float32, route, act=act),
                                   want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(_pt(args, torch.float32, "sw", act=act),
                               _ref(args, jnp.float32, "sw", act=act),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("M", [4, 128])
def test_bf16_matches_reference(M):
    args = _inputs(M, 128, 1024, seed=1)
    want = _ref(args, jnp.bfloat16, "interpret")
    for route in ("hw", "interpret", "sw"):
        got = _pt(args, torch.bfloat16, route)
        d = np.abs(got - want).max()
        assert d <= BF16_ABS and d <= BF16_REL * np.abs(want).max(), d


def test_narrow_output_width_matches():
    args = _inputs(8, 64, 256, Do=61, seed=2)
    want = _ref(args, jnp.float32, "interpret")
    got = _pt(args, torch.float32, "hw")
    assert got.shape == want.shape == (8, 61)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kind", ["stuck", "dropped_mac", "gain"])
def test_lane_fault_in_kernel_matches(kind):
    args = _inputs(8, 64, 256, seed=3)
    fault = dict(kind=kind, lanes=(0, 17, 63), width=64)
    with ref_lf.inject("swiglu_mlp", ref_lf.LaneFault(**fault)):
        want = _ref(args, jnp.float32, "interpret")
    with pt_lf.inject("swiglu_mlp", pt_lf.LaneFault(**fault)):
        got = _pt(args, torch.float32, "hw")
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert not np.allclose(got[:, 17], _pt(args, torch.float32, "hw")[:, 17])


@pytest.mark.parametrize("target", ["degraded_remap", "degraded_reduced"])
def test_degraded_lowerings_match_and_heal(target):
    args = _inputs(8, 64, 256, seed=4)
    fault = dict(kind="gain", lanes=(3, 40), width=64, gain=3.0)
    rfault, pfault = ref_lf.LaneFault(**fault), pt_lf.LaneFault(**fault)
    with ref_lf.known_map("swiglu_mlp", rfault, base="interpret"), \
            ref_lf.inject("swiglu_mlp", rfault):
        want = _ref(args, jnp.float32, target)
    with pt_lf.known_map("swiglu_mlp", pfault, base="hw"):
        clean = _pt(args, torch.float32, target)
        with pt_lf.inject("swiglu_mlp", pfault):
            got = _pt(args, torch.float32, target)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(got, clean)


def test_row_independent_oracle_is_bitwise_per_row():
    x, w1, w3, w2 = (torch.from_numpy(a) for a in _inputs(5, 64, 256, seed=5))
    batched = swiglu_ref(x, w1, w3, w2, row_independent=True)
    for i in range(5):
        assert torch.equal(batched[i:i + 1],
                           swiglu_ref(x[i:i + 1], w1, w3, w2))
    np.testing.assert_allclose(batched.numpy(),
                               swiglu_ref(x, w1, w3, w2).numpy(),
                               atol=F32_TOL, rtol=F32_TOL)


def test_flops_and_registration():
    assert swiglu_flops(4, 2560, 6912) == ref_flops(4, 2560, 6912)
    assert SWIGLU.name == "swiglu_mlp" and SWIGLU.tol == 2e-2


# ------------------------------------------- the Hopper kernel's launch plan
# Pure Python: the same plan the CUDA wrapper launches, checked here at every
# shape the port calls.  (D, F, Do) of the full-width models, the canary
# stage (train/runner.py), the smoke configs and a narrow w2 (the
# DEGRADED_REDUCED lowering slices w2 to the surviving lanes).
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.swiglu import kernel as hk  # noqa: E402

_WIDTHS = [(2560, 6912, 2560), (2048, 8192, 2048), (64, 128, 64),
           (128, 256, 128), (2560, 6912, 61), (128, 256, 61), (64, 128, 62)]
_CALLED = [(4, 2560, 6912, 2560), (128, 2560, 6912, 2560),
           (4, 2048, 8192, 2048), (384, 2048, 8192, 2048),
           (1, 2560, 6912, 2560), (200, 2560, 6912, 2560),
           (64, 64, 128, 64), (8, 2560, 6912, 61), (3, 128, 256, 128),
           (100, 128, 256, 61), (130, 2048, 8192, 2048)]
for _name in ("qwen1.5-4b-smoke", "zamba2-1.2b-smoke"):
    _cfg = get_config(_name)
    _CALLED += [(m, _cfg.d_model, _cfg.d_ff, _cfg.d_model)
                for m in (1, 4, 16, 64, 96)]
_M_SWEEP = list(range(1, 17)) + [63, 64, 65, 127, 128, 129, 192, 200, 384,
                                  1000, 4096]


@pytest.mark.parametrize("D,F,Do", _WIDTHS)
def test_plan_k_tiling_and_splits_do_not_change_with_M(D, F, Do):
    for ri in (False, True):
        seen = {(p.path, p.bk, p.dims, p.splits, p.k_per_split)
                for p in (hk.plan(M, D, F, Do, ri) for M in _M_SWEEP)}
        assert len(seen) == 1, seen
    assert hk.plan(4, D, F, Do).splits == hk.split_count(D, F, Do)


@pytest.mark.parametrize("M,D,F,Do", _CALLED)
def test_plan_is_legal_at_every_called_shape(M, D, F, Do):
    p = hk.plan(M, D, F, Do)
    Dp, Fp, Dop = p.dims
    t = hk.TILE
    assert (Dp, Fp, Dop) == tuple(-(-n // t) * t for n in (D, F, Do))
    assert p.nwg in (1, 2, 3) and p.bm == t * p.nwg and p.nsub in (1, 2)
    assert (p.nwg + 1) * 128 <= 1024
    assert all(0 < b <= hk.SMEM_LIMIT for b in p.smem)
    assert p.smem == (hk.ring_bytes(p.nwg), hk.ring_bytes(p.nwg, p.nsub))
    # the rows: every row in one tile, no empty tile
    assert (p.grid_a[0] - 1) * p.bm < M <= p.grid_a[0] * p.bm
    assert p.grid_b[0] == p.grid_a[0]
    # the columns: G and y covered exactly by whole tiles
    assert p.grid_a[1] * t == Fp and p.grid_a[2] == 1
    assert Dop % (t * p.nsub) == 0 and p.grid_b[1] * t * p.nsub == Dop
    # the slices: every F tile in exactly one slice, none empty
    nk = Fp // p.bk
    assert p.grid_b[2] == p.splits >= 1
    assert (p.splits - 1) * p.k_per_split < nk <= p.splits * p.k_per_split
    assert all(0 < g < 65536 for g in p.grid_a[1:] + p.grid_b[1:])


def test_plan_covers_the_sms_at_the_timed_shapes():
    for M, D, F, Do in _CALLED[:4]:
        p = hk.plan(M, D, F, Do)
        blocks_a = p.grid_a[0] * p.grid_a[1]
        blocks_b = p.grid_b[0] * p.grid_b[1] * p.grid_b[2]
        assert blocks_a >= 0.8 * hk.SM_COUNT, (M, D, F, Do, p)
        assert blocks_b >= 0.8 * hk.SM_COUNT, (M, D, F, Do, p)


@pytest.mark.parametrize("D,F,Do", _WIDTHS)
def test_row_independent_calls_share_one_path(D, F, Do):
    plans = {hk.plan(M, D, F, Do, row_independent=True)
             for M in range(1, 17)}
    assert {(p.path, p.nwg, p.nsub) for p in plans} == {("wgmma", 1, 1)}
    # decode-sized calls take that path with or without the promise
    assert {(p.path, p.nwg, p.nsub) for p in
            (hk.plan(M, D, F, Do) for M in range(1, 17))} == \
        {("wgmma", 1, 1)}
    assert hk.plan(384, D, F, Do, row_independent=True).nwg == 1


@pytest.mark.parametrize("M,D,F,Do", [(3, 100, 200, 61), (8, 64, 128, 64),
                                      (5, 130, 70, 1)])
def test_padding_and_slicing_round_trip(M, D, F, Do):
    x, w1, w3, w2 = (torch.from_numpy(a) for a in _inputs(M, D, F, Do,
                                                          seed=6))
    Dp, Fp, Dop = hk.plan(M, D, F, Do).dims
    xp, w1p, w3p = hk._pad(x, M, Dp), hk._pad(w1, Dp, Fp), \
        hk._pad(w3, Dp, Fp)
    w2p = hk._pad(w2, Fp, Dop)
    assert xp.shape == (M, Dp) and w2p.shape == (Fp, Dop)
    assert torch.equal(xp[:, :D], x) and not xp[:, D:].any()
    assert torch.equal(w2p[:F, :Do], w2) and not w2p[F:].any() \
        and not w2p[:, Do:].any()
    assert hk._pad(x, M, D) is x
    # zero rows and columns add nothing, and the extra lanes slice away
    for act in ("silu", "gelu"):
        got = swiglu_ref(xp, w1p, w3p, w2p, act=act)[:, :Do]
        np.testing.assert_allclose(got.numpy(), swiglu_ref(
            x, w1, w3, w2, act=act).numpy(), atol=F32_TOL, rtol=F32_TOL)


def test_wrapper_counts_nothing_on_the_cpu_and_rejects_other_devices():
    x, w1, w3, w2 = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(4, 64, 128, seed=7))
    before = hk.swiglu_fused.launches
    hk.swiglu_fused(x, w1, w3, w2, row_independent=True)
    assert hk.swiglu_fused.launches == before
    with pytest.raises(ValueError):
        hk.swiglu_fused(x.to("meta"), w1, w3, w2)


def test_scratch_is_kept_per_stream_and_grows():
    dev = torch.device("cpu")
    hk._SCRATCH.clear()
    a = hk._scratch(dev, 1, 100)
    assert a.numel() >= 100 and hk._scratch(dev, 1, 50) is a
    assert hk._scratch(dev, 2, 100) is not a          # another stream
    big = a.numel() + 1
    b = hk._scratch(dev, 1, big)
    assert b.numel() >= big and hk._scratch(dev, 1, 10) is b
    # calls larger than SCRATCH_KEEP take their own buffer
    huge = hk.SCRATCH_KEEP + 1
    assert hk._scratch(dev, 1, huge) is not hk._scratch(dev, 1, huge)
    assert hk._scratch(dev, 1, 10) is b
    hk._SCRATCH.clear()
