"""Flash attention of the port against the reference, on the CPU.

The same numpy inputs go through the reference (SW oracle, Pallas kernel
in interpret mode) and the port (SW oracle, INTERPRET replica, HW wrapper,
which on a CPU tensor runs the kernel's plain blocked version).  The
Hopper kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the same plain version there.

Tolerances: float32 against float32 agrees to float32 rounding of O(1)
values (2e-5 absolute and relative: the two sides sum in other orders);
bfloat16 holds the op's contract, ``tol`` = 2e-2 absolute, and a relative
bound of 1e-2 of the largest reference magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as ref_attention
from repro.kernels.flash_attention import attention_naive as ref_naive
from repro.kernels.flash_attention import attention_flops as ref_flops
from repro.viscosity import lanefault as ref_lf

from repro_torch.kernels.flash_attention import (ATTENTION, attention,
                                                 attention_flops,
                                                 attention_naive)
from repro_torch.viscosity import lanefault as pt_lf

F32_TOL = 2e-5
BF16_ABS, BF16_REL = 2e-2, 1e-2

# name, (B, Sq, Skv, H, Hkv, D), kwargs
CASES = [
    ("causal", (1, 128, 128, 2, 2, 32), dict(causal=True)),
    ("noncausal_cross", (2, 64, 192, 4, 4, 32), dict(causal=False)),
    ("gqa", (1, 128, 128, 8, 2, 64), dict(causal=True)),
    ("window_softcap", (2, 192, 192, 4, 2, 32),
     dict(causal=True, window=40, softcap=30.0)),
    ("kv_len_padding", (1, 200, 200, 2, 1, 32), dict(causal=True)),
]


@pytest.fixture(autouse=True)
def _clean_registries():
    ref_lf.reset()
    pt_lf.reset()
    yield
    ref_lf.reset()
    pt_lf.reset()


def _inputs(shape, seed=0, dv=None):
    B, Sq, Skv, H, Hkv, D = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, dv or D)).astype(np.float32)
    return q, k, v


def _ref(qkv, dtype, route, **kw):
    out = ref_attention(*(jnp.asarray(a, dtype) for a in qkv), route=route,
                        **kw)
    return np.asarray(out, np.float32)


def _pt(qkv, dtype, route, **kw):
    out = attention(*(torch.from_numpy(a).to(dtype) for a in qkv),
                    route=route, **kw)
    return out.float().numpy()


def _close_bf16(got, want):
    d = np.abs(got - want).max()
    assert d <= BF16_ABS, d
    assert d <= BF16_REL * np.abs(want).max(), (d, np.abs(want).max())


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("route", ["sw", "interpret"])
def test_f32_matches_reference(name, shape, kw, route):
    qkv = _inputs(shape)
    want = _ref(qkv, jnp.float32, route, **kw)
    got = _pt(qkv, torch.float32, route, **kw)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    if route == "interpret":   # the HW wrapper's CPU path is the same replica
        np.testing.assert_array_equal(_pt(qkv, torch.float32, "hw", **kw),
                                      got)


@pytest.mark.parametrize("name,shape,kw", [CASES[2], CASES[4]],
                         ids=["gqa", "kv_len_padding"])
def test_bf16_hw_matches_reference_interpret(name, shape, kw):
    qkv = _inputs(shape, seed=1)
    want = _ref(qkv, jnp.bfloat16, "interpret", **kw)
    for route in ("hw", "interpret", "sw"):
        _close_bf16(_pt(qkv, torch.bfloat16, route, **kw), want)


def test_narrow_value_width_matches():
    qkv = _inputs((1, 128, 128, 2, 2, 32), seed=2, dv=29)
    for ref_route, pt_route in (("interpret", "hw"), ("sw", "sw")):
        want = _ref(qkv, jnp.float32, ref_route)
        got = _pt(qkv, torch.float32, pt_route)
        assert got.shape == want.shape == (1, 128, 2, 29)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kind", ["stuck", "dropped_mac", "gain"])
def test_lane_fault_in_kernel_matches(kind):
    qkv = _inputs((1, 128, 128, 2, 2, 32), seed=3)
    args = dict(kind=kind, lanes=(0, 9, 31), width=32)
    with ref_lf.inject("flash_attention", ref_lf.LaneFault(**args)):
        want = _ref(qkv, jnp.float32, "interpret")
    with pt_lf.inject("flash_attention", pt_lf.LaneFault(**args)):
        got = _pt(qkv, torch.float32, "hw")
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    healthy = _pt(qkv, torch.float32, "hw")
    assert not np.allclose(got[..., 9], healthy[..., 9])


@pytest.mark.parametrize("target", ["degraded_remap", "degraded_reduced"])
def test_degraded_lowerings_match_and_heal(target):
    qkv = _inputs((1, 128, 128, 2, 2, 32), seed=4)
    args = dict(kind="stuck", lanes=(5, 6), width=32)
    rfault, pfault = ref_lf.LaneFault(**args), pt_lf.LaneFault(**args)
    with ref_lf.known_map("flash_attention", rfault, base="interpret"), \
            ref_lf.inject("flash_attention", rfault):
        want = _ref(qkv, jnp.float32, target)
    with pt_lf.known_map("flash_attention", pfault, base="hw"):
        clean = _pt(qkv, torch.float32, target)
        with pt_lf.inject("flash_attention", pfault):
            got = _pt(qkv, torch.float32, target)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # the rung heals the injected lanes: bit-identical to the clean run
    np.testing.assert_array_equal(got, clean)


def test_decode_style_call_matches():
    q, k, v = _inputs((2, 1, 48, 4, 2, 16), seed=5)
    off = np.array([20, 40], np.int32)
    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), route="interpret",
                                    q_offset=jnp.asarray(off),
                                    kv_len=jnp.asarray(off + 1)))
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), route="hw",
                    q_offset=torch.from_numpy(off),
                    kv_len=torch.from_numpy(off + 1)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_naive_with_ring_positions_matches():
    q, k, v = _inputs((2, 1, 32, 2, 2, 16), seed=6)
    kpos = np.tile(np.arange(32, dtype=np.int32)[None], (2, 1))
    kpos[:, 20:] = -1
    off = np.full((2,), 19, np.int32)
    want = np.asarray(ref_naive(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_offset=jnp.asarray(off),
                                k_positions=jnp.asarray(kpos)))
    got = attention_naive(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), q_offset=torch.from_numpy(off),
                          k_positions=torch.from_numpy(kpos)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_flops_and_registration():
    assert attention_flops(1, 128, 128, 20, 128) == \
        ref_flops(1, 128, 128, 20, 128)
    assert ATTENTION.name == "flash_attention" and ATTENTION.tol == 2e-2
    with pytest.raises(ValueError, match="INTERPRET"):
        from repro_torch.kernels.flash_attention.ops import _kernel_path
        meta = torch.zeros((1, 8, 1, 16), device="meta")
        _kernel_path(meta, meta, meta, interpret=True)
