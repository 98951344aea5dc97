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
