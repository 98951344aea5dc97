"""RWKV-6 WKV of the port against the reference, on the CPU.

The same numpy inputs go through the reference (the jnp oracles, the
Pallas kernel in interpret mode) and the port (the PyTorch oracles, the
INTERPRET replica ``wkv6_ref_blocked``, and the HW wrapper, which on a CPU
tensor runs that plain blocked version).  The Hopper kernel itself runs
only on the card (``chip_smoke.py``).  Inputs lie inside the scan's domain:
lw in [-4, -1e-4] (the model's clamp), r and k ~ N(0, 0.3^2),
v ~ N(0, 0.5^2), u ~ N(0, 0.5^2), so max |o| stays near 1-2, where one
bf16 ulp is at most 0.0078.

Tolerances: float32 against float32, 2e-5 absolute and 1e-5 of the largest
reference magnitude (the same algorithm in both packages: sums of at most
64 terms in other orders); bfloat16 outputs hold the op's ``tol`` of 2e-2
absolute and 1e-2 of the largest reference magnitude (one bf16 ulp of
rounding, taken at the same point by both).  The final state is float32
in both dtypes and holds the float32 bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.rwkv6_scan as ref_w
from repro.viscosity import lanefault as ref_lf

import repro_torch.kernels.rwkv6_scan as pt_w
from repro_torch.kernels.rwkv6_scan import kernel as pt_kernel
from repro_torch.viscosity import DEGRADED_REDUCED, DEGRADED_REMAP, HW
from repro_torch.viscosity import lanefault as pt_lf

F32 = (2e-5, 1e-5)
BF16 = (2e-2, 1e-2)


@pytest.fixture(autouse=True)
def _clean_registries():
    ref_lf.reset()
    pt_lf.reset()
    yield
    ref_lf.reset()
    pt_lf.reset()


def _inputs(B, S, H, K, V=None, seed=0, lw_range=(-4.0, -1e-4)):
    """r, k, v, lw, u as numpy f32; lw uniform in ``lw_range``."""
    rng = np.random.default_rng(seed)
    V = V or K
    r = rng.normal(0, 0.3, size=(B, S, H, K))
    k = rng.normal(0, 0.3, size=(B, S, H, K))
    v = rng.normal(0, 0.5, size=(B, S, H, V))
    lw = rng.uniform(*lw_range, size=(B, S, H, K))
    u = rng.normal(0, 0.5, size=(H, K))
    return tuple(a.astype(np.float32) for a in (r, k, v, lw, u))


def _jx(args, dtype):
    *rkvw, u = args
    return tuple(jnp.asarray(a, dtype) for a in rkvw) + (jnp.asarray(u),)


def _pt(args, dtype):
    *rkvw, u = (torch.from_numpy(a) for a in args)
    return tuple(a.to(dtype) for a in rkvw) + (u,)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    d = np.abs(got - want).max()
    assert d <= tol[0] and d <= tol[1] * max(np.abs(want).max(), 1.0), d


DTYPES = [("float32", jnp.float32, torch.float32, F32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, BF16)]


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_oracles_match_reference(name, jdt, tdt, tol):
    args = _inputs(2, 45, 3, 16, seed=1)
    j, t = _jx(args, jdt), _pt(args, tdt)
    ro, rs = ref_w.wkv6_scan_ref(*j)
    po, ps = pt_w.wkv6_scan_ref(*t)
    _close(po, ro, tol)
    _close(ps, rs, F32)
    ro, rs = ref_w.wkv6_chunked(*j, chunk=16)
    po, ps = pt_w.wkv6_chunked(*t, chunk=16)
    _close(po, ro, tol)
    _close(ps, rs, F32)
    state = np.random.default_rng(2).normal(size=(2, 3, 16, 16)
                                            ).astype(np.float32)
    ro, rs = ref_w.wkv6_step(jnp.asarray(state), *(a[:, 7] for a in j[:4]),
                             j[4])
    po, ps = pt_w.wkv6_step(torch.from_numpy(state), *(a[:, 7] for a in t[:4]),
                            t[4])
    _close(po, ro, tol)
    _close(ps, rs, F32)


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("S,chunk", [(21, 8), (40, 16), (12, 16)])
def test_blocked_and_hw_match_reference_interpret(name, jdt, tdt, tol, S,
                                                  chunk):
    """S=21 at chunk 8: three chunks, the last padded; S=40 at chunk 16:
    three chunks, the last padded; S=12 at chunk 16: L = S, one chunk."""
    args = _inputs(2, S, 3, 16, seed=S)
    want = ref_w.wkv6(*_jx(args, jdt), route="interpret", chunk=chunk)
    t = _pt(args, tdt)
    for route in ("hw", "interpret"):
        _close(pt_w.wkv6(*t, route=route, chunk=chunk), want, tol)
    # the HW lowering's final state is the kernel's (on CPU: the replica's)
    o, state = pt_w.wkv6(*t, route=HW, chunk=chunk, with_state=True)
    _close(o, want, tol)
    _, ref_state = ref_w.wkv6_chunked(*_jx(args, jdt), chunk=chunk)
    _close(state, ref_state, F32)


def test_blocked_at_the_clamp_bound_matches_the_scan():
    """lw = -4 on every token: exp(-la) reaches e^64 at chunk 16, the edge
    of the factorization's f32 range; the blocked replica stays finite and
    equals the token-by-token oracle."""
    args = _inputs(1, 48, 2, 16, seed=9, lw_range=(-4.0, -4.0))
    t = _pt(args, torch.float32)
    oracle_o, oracle_s = ref_w.wkv6_scan_ref(*_jx(args, jnp.float32))
    o, s = pt_w.wkv6_ref_blocked(*t, chunk=16)
    _close(o, oracle_o, F32)
    _close(s, oracle_s, F32)


@pytest.mark.parametrize("target,kind", [(DEGRADED_REMAP, "dropped_mac"),
                                         (DEGRADED_REDUCED, "stuck")])
def test_degraded_lowerings_heal_an_injected_lane_fault(target, kind):
    """The port-side counterpart of the reference's DEGRADED tests for
    ``rwkv6_wkv``, on in-domain inputs: output bit-identical with and
    without injection, dead lanes equal to the SW oracle, the rest within
    the stage's tolerance."""
    args = _pt(_inputs(2, 32, 2, 16, seed=3), torch.float32)
    fault = pt_lf.LaneFault(kind=kind, lanes=(2, 15), width=16)
    spec = pt_w.WKV6
    ref = spec.ref(*args)
    with pt_lf.known_map("rwkv6_wkv", fault, base=HW):
        fn = spec.lower(target)
        clean = fn(*args)
        with pt_lf.inject("rwkv6_wkv", fault):
            injected = fn(*args)
            raw = spec.lower(HW)(*args)
    assert torch.equal(injected, clean)
    assert torch.equal(injected[..., list(fault.lanes)],
                       ref[..., list(fault.lanes)])
    assert not torch.equal(raw[..., 2], clean[..., 2])  # the fault bit
    _close(injected, ref.numpy(), (spec.tol, 1e-2))


@pytest.mark.parametrize("kind", ["stuck", "dropped_mac", "gain"])
def test_lane_fault_in_kernel_matches_reference(kind):
    args = _inputs(1, 40, 2, 16, seed=4)
    fault = dict(kind=kind, lanes=(0, 9), width=16)
    with ref_lf.inject("rwkv6_wkv", ref_lf.LaneFault(**fault)):
        want = ref_w.wkv6(*_jx(args, jnp.float32), route="interpret",
                          chunk=16)
    with pt_lf.inject("rwkv6_wkv", pt_lf.LaneFault(**fault)):
        got = pt_w.wkv6(*_pt(args, torch.float32), route=HW, chunk=16)
    _close(got, want, F32)


def test_cuda_wrapper_checks_operands_before_launch():
    r, k, v, lw, u = _pt(_inputs(1, 32, 2, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="u must be torch.float32"):
        pt_kernel._launch(r, k, v, lw, u.bfloat16(), L=16,
                          lane_fault=None, with_state=False)
    with pytest.raises(ValueError, match="lw must be torch.bfloat16"):
        pt_kernel._launch(r, k, v, lw.float(), u, L=16, lane_fault=None,
                          with_state=False)
    with pytest.raises(ValueError, match="exceed the kernel's 64"):
        wide = torch.zeros((1, 32, 2, 65), dtype=torch.bfloat16)
        pt_kernel._launch(r, k, wide, lw, u, L=16, lane_fault=None,
                          with_state=False)
    with pytest.raises(ValueError, match="do not agree"):
        pt_kernel._launch(r, k[:, :16], v, lw, u, L=16, lane_fault=None,
                          with_state=False)
    with pytest.raises(ValueError, match="must be in"):
        pt_kernel._launch(r, k, v, lw, u, L=12, lane_fault=None,
                          with_state=False)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_w.wkv6_chunked_cuda(r.to("meta"), k, v, lw, u)


def test_chunk_above_16_is_refused():
    """The factorization takes exp(-la) with |la| up to 4 L: past L = 16 it
    leaves f32 range, so the wrapper (on either device) and the HW op
    refuse a longer chunk; a sequence shorter than the chunk is fine."""
    args = _pt(_inputs(1, 64, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="exceeds 16"):
        pt_w.wkv6_chunked_cuda(*args, chunk=32)
    with pytest.raises(ValueError, match="exceeds 16"):
        pt_w.wkv6(*args, route=HW, chunk=32)
    short = tuple(a[:, :12] for a in args[:4]) + (args[4],)
    o, _ = pt_w.wkv6_chunked_cuda(*short, chunk=32)
    assert o.shape == (1, 12, 2, 16)


def test_flops_and_registration():
    assert pt_w.wkv6_flops(1, 512, 32, 64, 64) == \
        ref_w.wkv6_flops(1, 512, 32, 64, 64)
    assert pt_w.WKV6.name == "rwkv6_wkv" and pt_w.WKV6.tol == 2e-2
