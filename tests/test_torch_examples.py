"""The port's examples (``examples_torch/``) on the CPU, against the
reference's (``examples/``) where those are deterministic and need no
forced device count.

Each example's ``main(device="cpu")`` runs at its reference config.  Cut:
quickstart trains 24 steps, not 120 (its fault at step 12, the canary
every 8 steps, a checkpoint every 5, the same fractions of the run as 60,
40 and 25 of 120).  The others run as the reference does.  The
reference's ``elastic_train.py`` forces 8 host devices at import, so it
does not run here.  Compared with the reference: ``datacenter_sim``'s
analytic sweep prints the same lines, ``casestudy_faults``' latency-model
figures print the same, and ``lane_fault_smoke``'s checks hold in both
(the port's add a relative bound against the SW oracle, which the
reference's f32 ports need not).
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_with_faults", "casestudy_faults",
            "lane_fault_smoke", "elastic_train", "datacenter_sim")


def _load(folder: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load("examples_torch", name)


def _last_line(out: str) -> str:
    return out.strip().splitlines()[-1]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_the_card_unless_told(name):
    """``main()`` resolves the card and raises on a machine without one;
    every example takes ``--device``."""
    mod = _port(name)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main()
    with pytest.raises(SystemExit):
        mod.cli(["--help"])


def test_quickstart(capsys):
    s = _port("quickstart").main(device="cpu", steps=24)
    assert _last_line(capsys.readouterr().out).startswith("OK:")
    assert s["compiles"] == 1 and s["faulty"] == ["flash_attention"]
    assert s["fault_step"] == 12 and len(s["losses"]) == 24
    assert all(map(torch.isfinite, torch.tensor(s["losses"])))


def test_serve_with_faults(capsys):
    s = _port("serve_with_faults").main(device="cpu")
    assert _last_line(capsys.readouterr().out).startswith("OK:")
    assert s["kernel_route"] == "interpret" and s["requests"] == 8
    assert (s["recompile"]["recompiles"], s["resident"]["recompiles"],
            s["sw"]["recompiles"]) == (1, 0, 0)
    assert s["modes_identical"] and s["sw"]["bit_identical"]


def test_lane_fault_smoke_checks_hold_in_both(capsys):
    s = _port("lane_fault_smoke").main(device="cpu")
    out = capsys.readouterr().out
    assert _last_line(out).startswith("OK:")
    assert s["ok"] and s["route"] == "interpret" and all(s["checks"].values())
    assert _port("lane_fault_smoke").cli(["--device", "cpu"]) == 0
    capsys.readouterr()
    assert _load("examples", "lane_fault_smoke").main() == 0
    ref = json.loads(capsys.readouterr().out)
    assert ref["ok"] and all(ref["checks"].values())
    assert set(ref["checks"]) < set(s["checks"])
    rel = s["rel_err"]
    assert max(rel["clean"], rel["remap"], rel["reduced"]) <= s["rel_tol"]
    assert rel["dropped_lanes"] > s["rel_tol"]


def test_casestudy_faults_latency_figures_match(capsys):
    from repro.core import latency as ref_latency
    s = _port("casestudy_faults").main(device="cpu")
    port = capsys.readouterr().out
    _load("examples", "casestudy_faults").main()
    ref = capsys.readouterr().out

    def figures(out):
        return [ln for ln in out.splitlines()
                if "speedup vs software" in ln or "% of software" in ln]

    assert _last_line(port).startswith("OK:")
    assert len(figures(port)) == 3 and figures(port) == figures(ref)
    for name, model, idx in (("fft", ref_latency.fft_model(), 3),
                             ("dct", ref_latency.dct_model(), 4)):
        assert s[name]["speedup_vs_sw"] == ref_latency.speedup_vs_sw(model)
        assert s[name]["speedup_vs_sw_one_fault"] == \
            ref_latency.speedup_vs_sw(model, [idx])
        assert s[name]["found"] == [s[name]["stage"]]
    assert s["aes"]["one_fault_pct_of_sw"] == \
        100 / ref_latency.speedup_vs_sw(ref_latency.aes_model(3), [1])
    assert s["aes"]["found"] == ["aes_s5"] and s["aes"]["rerouted_exact"]


def test_elastic_train(capsys):
    s = _port("elastic_train").main(device="cpu")
    assert _last_line(capsys.readouterr().out).startswith("OK:")
    assert s["mesh"] == [[2, 4], [1, 4]] and s["quarantined"] == [4, 5, 6, 7]
    assert s["opt_count"] == 20
    assert [len(x) for x in s["losses"]] == [10, 10]


def test_datacenter_sim_rows_match_the_reference(capsys, monkeypatch):
    from repro.core.datacenter import fig2_sweep
    mod = _port("datacenter_sim")
    s = mod.main(device="cpu")
    port = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["datacenter_sim.py"])
    _load("examples", "datacenter_sim").main()
    ref = capsys.readouterr().out
    assert _last_line(port).startswith("OK:")
    assert port.strip().splitlines()[:-1] == ref.strip().splitlines()
    want = fig2_sweep(mod.RATES, n_chips=10_000, ticks=1460,
                      degradation=s["degradation"], monte_carlo=False)
    assert s["rows"] == [tuple(r) for r in want]


def test_datacenter_sim_replay_waits_for_the_benchmark(capsys):
    assert _port("datacenter_sim").cli(["--replay"]) == 2
    assert "waits for the port's benchmark" in capsys.readouterr().out
