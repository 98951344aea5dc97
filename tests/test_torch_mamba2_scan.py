"""Mamba2 SSD of the port against the reference, on the CPU.

The same numpy inputs go through the reference (the jnp oracles, the
Pallas kernel in interpret mode) and the port (the PyTorch oracles, the
INTERPRET replica ``ssd_ref_blocked``, and the HW wrapper, which on a CPU
tensor runs that plain blocked version).  The Hopper kernel itself runs
only on the card (``chip_smoke.py``).  Inputs lie inside the scan's domain:
dt = softplus(.) > 0 and A = -exp(A_log) < 0.

Tolerances: float32 against float32, 2e-4 absolute and 2e-3 relative (the
reference's own chunked-vs-scan tolerance: sums of up to 128 exponentially
weighted terms in other orders); bfloat16 outputs hold the op's ``tol`` of
2e-2 absolute and 1e-2 of the largest reference magnitude (one bf16 ulp of
rounding, taken at the same point by both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.mamba2_scan as ref_m
from repro.viscosity import lanefault as ref_lf

import repro_torch.kernels.mamba2_scan as pt_m
from repro_torch.kernels.mamba2_scan import kernel as pt_kernel
from repro_torch.viscosity import DEGRADED_REDUCED, DEGRADED_REMAP, HW
from repro_torch.viscosity import lanefault as pt_lf

F32 = (2e-4, 2e-3)
BF16 = (2e-2, 1e-2)


@pytest.fixture(autouse=True)
def _clean_registries():
    ref_lf.reset()
    pt_lf.reset()
    yield
    ref_lf.reset()
    pt_lf.reset()


def _inputs(B, S, H, P, N, seed=0, dt_range=None, a_max=2.0):
    """x, dt, A, B_, C as numpy f32: dt = softplus(N(-1, 0.5)) (about
    0.1-0.8) or uniform in ``dt_range``; A = -linspace(0.3, a_max)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    if dt_range is None:
        dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, size=(B, S, H))))
    else:
        dt = rng.uniform(*dt_range, size=(B, S, H))
    A = -np.linspace(0.3, a_max, H)
    Bm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    return x, dt.astype(np.float32), A.astype(np.float32), Bm, C


def _jx(args, dtype):
    x, dt, A, Bm, C = args
    return (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, dtype), jnp.asarray(C, dtype))


def _pt(args, dtype):
    x, dt, A, Bm, C = (torch.from_numpy(a) for a in args)
    return x.to(dtype), dt, A, Bm.to(dtype), C.to(dtype)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    d = np.abs(got - want).max()
    assert d <= tol[0] + tol[1] * np.abs(want).max(), d


DTYPES = [("float32", jnp.float32, torch.float32, F32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, BF16)]


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_oracles_match_reference(name, jdt, tdt, tol):
    args = _inputs(2, 70, 3, 16, 8, seed=1)
    j, t = _jx(args, jdt), _pt(args, tdt)
    ry, rh = ref_m.ssd_scan_ref(*j)
    py, ph = pt_m.ssd_scan_ref(*t)
    _close(py, ry, tol)
    _close(ph, rh, F32)
    ry, rh = ref_m.ssd_chunked(*j, chunk=32)
    py, ph = pt_m.ssd_chunked(*t, chunk=32)
    _close(py, ry, tol)
    _close(ph, rh, F32)
    state = np.random.default_rng(2).normal(size=(2, 3, 8, 16)
                                            ).astype(np.float32)
    ry, rh = ref_m.ssd_step(jnp.asarray(state), j[0][:, 5], j[1][:, 5],
                            j[2], j[3][:, 5], j[4][:, 5])
    py, ph = pt_m.ssd_step(torch.from_numpy(state), t[0][:, 5], t[1][:, 5],
                           t[2], t[3][:, 5], t[4][:, 5])
    _close(py, ry, tol)
    _close(ph, rh, F32)


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("S,chunk", [(40, 16), (100, 128), (200, 128)])
def test_blocked_and_hw_match_reference_interpret(name, jdt, tdt, tol, S,
                                                  chunk):
    """S=40 at chunk 16: three chunks, the last padded; S=100 at chunk
    128: L = S, one chunk; S=200: two chunks of 128, the second padded."""
    args = _inputs(2, S, 3, 16, 8, seed=S)
    want = ref_m.ssd(*_jx(args, jdt), route="interpret", chunk=chunk)
    t = _pt(args, tdt)
    for route in ("hw", "interpret"):
        _close(pt_m.ssd(*t, route=route, chunk=chunk), want, tol)
    # the HW lowering's final state is the kernel's (on CPU: the replica's)
    y, state = pt_m.ssd(*t, route=HW, chunk=chunk, with_state=True)
    _close(y, want, tol)
    _, ref_state = ref_m.ssd_chunked(*_jx(args, jdt), chunk=chunk)
    _close(state, ref_state, F32 if name == "float32" else BF16)


def test_masked_exponent_stays_finite_where_reference_is_nan():
    """At chunk 128 with decays as large as zamba2-1.2b's (A down to -16,
    dt 0.05-1) a chunk's cumulative decay passes e^88.  The reference's
    ``ssd_chunked`` multiplies exp(cum_i - cum_j) by the mask
    (``src/repro/kernels/mamba2_scan/ref.py:75``), so the upper triangle
    gives inf * 0 = NaN; the port selects the triangle before the
    exponent and equals the token-by-token oracle."""
    args = _inputs(1, 200, 4, 16, 8, seed=7, dt_range=(0.05, 1.0),
                   a_max=16.0)
    j, t = _jx(args, jnp.float32), _pt(args, torch.float32)
    ref_y, _ = ref_m.ssd_chunked(*j, chunk=128)
    assert np.isnan(np.asarray(ref_y)).any()
    oracle_y, oracle_h = ref_m.ssd_scan_ref(*j)
    y, h = pt_m.ssd_chunked(*t, chunk=128)
    _close(y, oracle_y, F32)
    _close(h, oracle_h, F32)
    y, h = pt_m.ssd(*t, route=HW, chunk=128, with_state=True)
    _close(y, oracle_y, F32)
    _close(h, oracle_h, F32)


@pytest.mark.parametrize("target,kind", [(DEGRADED_REMAP, "dropped_mac"),
                                         (DEGRADED_REDUCED, "stuck")])
def test_degraded_lowerings_heal_an_injected_lane_fault(target, kind):
    """The port-side counterpart of the reference's DEGRADED tests for
    ``mamba2_ssd``, on in-domain inputs: output bit-identical with and
    without injection, dead lanes equal to the SW oracle, the rest within
    the stage's tolerance."""
    args = _pt(_inputs(2, 64, 2, 16, 8, seed=3), torch.float32)
    fault = pt_lf.LaneFault(kind=kind, lanes=(2, 15), width=16)
    spec = pt_m.SSD
    ref = spec.ref(*args)
    with pt_lf.known_map("mamba2_ssd", fault, base=HW):
        fn = spec.lower(target)
        clean = fn(*args)
        with pt_lf.inject("mamba2_ssd", fault):
            injected = fn(*args)
            raw = spec.lower(HW)(*args)
    assert torch.equal(injected, clean)
    assert torch.equal(injected[..., list(fault.lanes)],
                       ref[..., list(fault.lanes)])
    assert not torch.equal(raw[..., 2], clean[..., 2])  # the fault bit
    _close(injected, ref.numpy(), (spec.tol, 1e-2))


@pytest.mark.parametrize("kind", ["stuck", "dropped_mac", "gain"])
def test_lane_fault_in_kernel_matches_reference(kind):
    args = _inputs(1, 48, 2, 16, 8, seed=4)
    fault = dict(kind=kind, lanes=(0, 9), width=16)
    with ref_lf.inject("mamba2_ssd", ref_lf.LaneFault(**fault)):
        want = ref_m.ssd(*_jx(args, jnp.float32), route="interpret",
                         chunk=16)
    with pt_lf.inject("mamba2_ssd", pt_lf.LaneFault(**fault)):
        got = pt_m.ssd(*_pt(args, torch.float32), route=HW, chunk=16)
    _close(got, want, F32)


def test_cuda_wrapper_checks_operands_before_launch():
    x, dt, A, Bm, C = _pt(_inputs(1, 32, 2, 16, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        pt_kernel._launch(x, dt.bfloat16(), A, Bm, C, L=32,
                          lane_fault=None, with_state=False)
    with pytest.raises(ValueError, match="exceed the kernel's 64"):
        wide = torch.zeros((1, 32, 2, 65), dtype=torch.bfloat16)
        pt_kernel._launch(wide, dt, A, Bm, C, L=32, lane_fault=None,
                          with_state=False)
    with pytest.raises(ValueError, match="must be in"):
        pt_kernel._launch(x, dt, A, Bm, C, L=24, lane_fault=None,
                          with_state=False)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_m.ssd_chunked_cuda(x.to("meta"), dt, A, Bm, C)


def test_flops_and_registration():
    assert pt_m.ssd_flops(1, 384, 64, 64, 64) == \
        ref_m.ssd_flops(1, 384, 64, 64, 64)
    assert pt_m.SSD.name == "mamba2_ssd" and pt_m.SSD.tol == 2e-2
