"""The latency model (paper §V, Figs. 5-8) in both packages.

``tests/test_latency_model.py`` restated with the module as a parameter:
the reference's ``repro.core.latency`` and the port's
``repro_torch.core.latency`` (a stdlib-only copy) must each reproduce the
paper's reported numbers and laws.  Then every public function of the two
modules is held equal on a grid of inputs, and the fleet's degradation
curve is wired from the port's latency model into the port's datacenter
model, as ``tests/test_datacenter.py`` does for the reference.
"""
import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

import repro.core.latency as ref_latency
import repro_torch.core.latency as pt_latency

MODULES = pytest.mark.parametrize("L", [ref_latency, pt_latency],
                                  ids=["reference", "port"])


# ----------------------------------------------------- Fig. 5 case studies
@MODULES
def test_case_study_reported_numbers(L):
    m = L.fft_model()
    assert L.speedup_vs_sw(m) == pytest.approx(13.5, rel=0.02)
    assert L.speedup_vs_sw(m, [2]) == pytest.approx(5.181, rel=0.02)
    assert 0.6 <= sum(m.fb_stage) / m.sw_total <= 1.2
    d = L.dct_model()
    assert L.speedup_vs_sw(d) == pytest.approx(5.3, rel=0.02)
    assert L.speedup_vs_sw(d, [0]) == pytest.approx(2.87, rel=0.02)
    # AES: one fault -> 58% of software; stage count has no effect
    assert 1.0 / L.speedup_vs_sw(L.aes_model(3), [1]) == pytest.approx(
        0.58, abs=0.02)
    assert 1.0 / L.speedup_vs_sw(L.aes_model(11), [5]) == pytest.approx(
        0.58, abs=0.02)
    # the abstract's 1.7x-5.16x band under a single fault
    vals = [L.speedup_vs_sw(L.fft_model(), [0]),
            L.speedup_vs_sw(L.dct_model(), [0]), 1.0 / 0.58]
    assert min(vals) >= 1.7 * 0.98 and max(vals) <= 5.2


# -------------------------------------------------- Fig. 6 pass-through
@MODULES
def test_fig6_laws_and_corners(L):
    sizes, stages = [30_000, 120_000, 300_000], [3, 6, 9, 12]
    grid = {(op, n): L.speedup_vs_sw(L.passthrough_model(op, n), [0])
            for op in sizes for n in stages}
    for op in sizes:
        for a, b in zip(stages, stages[1:]):
            assert grid[(op, b)] > grid[(op, a)]
    for n in stages:
        for a, b in zip(sizes, sizes[1:]):
            assert grid[(b, n)] > grid[(a, n)]
    assert grid[(300_000, 9)] - grid[(300_000, 3)] > \
        grid[(30_000, 9)] - grid[(30_000, 3)]
    assert grid[(30_000, 9)] == pytest.approx(3.3, rel=0.15)
    assert grid[(300_000, 12)] == pytest.approx(9.7, rel=0.15)


# ------------------------------------------------------ Fig. 7 two faults
@MODULES
def test_fig7_two_fault_claims(L):
    m6 = L.passthrough_model(30_000, 6)
    s1, s2 = L.speedup_vs_sw(m6, [0]), L.speedup_vs_sw(m6, [0, 3])
    assert s1 == pytest.approx(2.17, rel=0.35)
    assert s2 == pytest.approx(1.3, rel=0.45) and s2 > 1.0
    m12 = L.passthrough_model(240_000, 12)
    assert L.speedup_vs_sw(m12, [0, 6]) == pytest.approx(4.30, rel=0.25)
    m10 = L.passthrough_model(200_000, 10)
    assert L.speedup_vs_sw(m10, [0, 5]) == pytest.approx(3.65, rel=0.25)
    ratio = L.speedup_vs_sw(m12, [0, 6]) / L.speedup_vs_sw(m12, [0])
    assert 0.4 <= ratio <= 0.75
    # many faults can lose to software; a large op tolerates 8
    assert L.speedup_vs_sw(m6, [0, 2, 4]) < 1.25
    assert L.speedup_vs_sw(m12, list(range(8))) > 1.0


# ---------------------------------------------------- Fig. 8 FPGA fallback
@MODULES
def test_fig8_fpga_fallback(L):
    m = L.passthrough_model(60_000, 6)
    sw = L.speedup_vs_sw(m, [0], fallback_speedup=1.0)
    speedups = [L.speedup_vs_sw(m, [0], fallback_speedup=f)
                for f in (35, 100, 200)]
    assert all(s > sw for s in speedups)
    assert speedups[0] < speedups[1] < speedups[2]
    assert speedups[2] - speedups[1] < speedups[1] - speedups[0]
    assert speedups[2] <= L.speedup_vs_sw(m) * 1.001
    # a hot spare connected directly keeps >= 80% of the accelerator
    m = L.passthrough_model(600_000, 6, t_q=1200.0)
    direct = L.speedup_vs_sw(m, [0], fallback_speedup=200,
                             direct_fallback=True) / L.speedup_vs_sw(m)
    routed = L.speedup_vs_sw(m, [0], fallback_speedup=200) / \
        L.speedup_vs_sw(m)
    assert direct >= 0.8 and routed < direct


@MODULES
@settings(max_examples=20, deadline=None)
@given(op=st.integers(20_000, 500_000), n=st.integers(2, 16),
       k=st.integers(0, 2))
def test_property_more_faults_never_faster(L, op, n, k):
    m = L.passthrough_model(op, n)
    faults = list(range(k))
    if k < n - 1:
        assert L.exec_time(m, faults + [k]) >= L.exec_time(m, faults)
    f = [L.throughput_factor(m, i) for i in range(min(3, n))]
    assert all(0 < x <= 1.0 + 1e-9 for x in f)
    assert all(a >= b for a, b in zip(f, f[1:]))


# ------------------------------------------------- the two modules agree
def test_every_public_function_agrees():
    names = sorted(n for n in dir(ref_latency) if not n.startswith("_")
                   and n not in ("annotations", "dataclass", "Sequence",
                                 "Tuple"))
    assert names == sorted(n for n in dir(pt_latency) if not n.startswith(
        "_") and n not in ("annotations", "dataclass", "Sequence", "Tuple"))
    for name in ("FFT_REPORTED", "DCT_REPORTED", "AES_REPORTED"):
        assert getattr(pt_latency, name) == getattr(ref_latency, name)

    def same(a, b):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)

    same(pt_latency.fft_model(), ref_latency.fft_model())
    same(pt_latency.dct_model(), ref_latency.dct_model())
    for n in (3, 11):
        same(pt_latency.aes_model(n), ref_latency.aes_model(n))
    same(pt_latency.AccelModel.uniform("u", 5, 1e5, t_q=50.0),
         ref_latency.AccelModel.uniform("u", 5, 1e5, t_q=50.0))
    same(pt_latency.fit_two_point("f", 4, 0.1, 0.3),
         ref_latency.fit_two_point("f", 4, 0.1, 0.3))
    for op in (30_000, 240_000):
        for n in (3, 6, 12):
            for kw in ({}, {"fb_frac": 0.7, "t_q": 800.0}):
                pm = pt_latency.passthrough_model(op, n, **kw)
                rm = ref_latency.passthrough_model(op, n, **kw)
                same(pm, rm)
                for faulty in ((), (0,), (0, n - 1), tuple(range(n - 1))):
                    for fs in (1.0, 35.0):
                        for direct in (False, True):
                            args = (faulty, fs, direct)
                            assert pt_latency.exec_time(pm, *args) == \
                                ref_latency.exec_time(rm, *args)
                            assert pt_latency.speedup_vs_sw(pm, *args) == \
                                ref_latency.speedup_vs_sw(rm, *args)
                    assert pt_latency._crossings(n, faulty) == \
                        ref_latency._crossings(n, faulty)
                for k in range(n + 1):
                    assert pt_latency.throughput_factor(pm, k, 35.0) == \
                        ref_latency.throughput_factor(rm, k, 35.0)


def test_degradation_from_case_study_on_the_port():
    """The port's fleet degradation curve wires to the port's latency
    model's throughput_factor (FFT case study)."""
    from repro_torch.core.datacenter import simulate_fleet
    m = pt_latency.fft_model()
    deg = tuple(pt_latency.throughput_factor(m, k) for k in range(3))
    assert deg[0] == 1.0 and deg[1] == pytest.approx(0.38, abs=0.02)
    r = simulate_fleet(2000, 200, 5e-4, mode="vfa", max_faults=3,
                       degradation=deg, seed=0)
    assert 0.9 < r.throughput <= 1.0
