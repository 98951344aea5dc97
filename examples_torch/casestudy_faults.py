"""The paper's case studies, end to end, on the port: FFT / AES / DCT
staged accelerators with fault injection, canary detection, quarantine,
and latency-model reporting (Fig. 5 numbers).

AES compares its canary at tolerance 0, so its sweep runs the Fig. 4
checksum, which on the card is the Hopper kernel (``csrc/checksum.cu``).

Run:  PYTHONPATH=src python examples_torch/casestudy_faults.py
      [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CanaryChecker, FaultState, StagedAccelerator, \
    inject
from repro_torch.core.casestudies import (aes_accelerator, dct_accelerator,
                                          dct_reference, fft_accelerator,
                                          fft_reference)
from repro_torch.core.latency import (aes_model, dct_model, fft_model,
                                      speedup_vs_sw)
from repro_torch.core.stage import Stage
from repro_torch.device import resolve_device


def demo(name, acc, x, reference, model, fault_stage_idx):
    ref = reference(x)
    stage = acc.stages[fault_stage_idx].name
    # 1) break the hardware path of one stage
    stages = list(acc.stages)
    stages[fault_stage_idx] = inject(stages[fault_stage_idx], kind="gain",
                                     magnitude=0.25)
    broken = StagedAccelerator(name, stages)
    err_bad = (broken.run(x) - ref).abs().max().item()
    # 2) canary detection -> quarantine
    state = FaultState()
    found = CanaryChecker(broken.stages).sweep(state)
    sig = state.signature(broken.stage_names)
    # 3) reroute: output restored
    err_fixed = (broken.run(x, sig) - ref).abs().max().item()
    s0 = speedup_vs_sw(model)
    s1 = speedup_vs_sw(model, [fault_stage_idx])
    print(f"{name.upper():>5}: fault in {stage} -> output err {err_bad:.2e}"
          f" | canary found {found} | rerouted err {err_fixed:.2e}")
    print(f"       speedup vs software: {s0:.2f}x healthy -> {s1:.2f}x "
          f"under one fault (paper Fig. 5)")
    assert err_bad > 1e-4 and err_fixed < 1e-3 and found == [stage]
    return {"stage": stage, "found": found, "err_faulty": err_bad,
            "err_rerouted": err_fixed, "speedup_vs_sw": s0,
            "speedup_vs_sw_one_fault": s1}


def main(device=None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64)) +
                         1j * rng.normal(size=(4, 64))).to(
                             torch.complex64).to(dev)
    fft = fft_accelerator(64, device=dev)
    summary = {"device": str(dev),
               "fft": demo("fft", fft, x, fft_reference, fft_model(), 3)}

    xd = torch.from_numpy(rng.normal(size=(4, 8, 8))).float().to(dev)
    dct = dct_accelerator(device=dev)
    summary["dct"] = demo("dct", dct, xd, dct_reference, dct_model(), 4)

    # AES: integer datapath -> use a stuck-at corruption + checksum canary
    key = np.arange(16, dtype=np.uint8)
    aes = aes_accelerator(key, 11, device=dev)
    xa = torch.from_numpy(rng.integers(0, 256, size=(4, 16)).astype(
        np.uint8)).to(dev)
    ref = aes.run(xa)
    stages = list(aes.stages)

    def corrupt_round(fn):
        def bad(s):
            return fn(s) ^ 0x40        # stuck bit in the datapath
        return bad

    s5 = stages[5]
    stages[5] = Stage(name=s5.name, hw=corrupt_round(s5.hw), sw=s5.sw,
                      ports=s5.ports, tol=0.0, device=dev)
    broken = StagedAccelerator("aes", stages)
    state = FaultState()
    found = CanaryChecker(broken.stages).sweep(state)
    sig = state.signature(broken.stage_names)
    exact = bool(torch.equal(broken.run(xa, sig), ref))
    m = aes_model(3)
    pct = 100 / speedup_vs_sw(m, [1])
    print(f"  AES: checksum canary found {found}; rerouted output exact: "
          f"{exact}; 1-fault time {pct:.0f}% of software (paper: 58%)")
    assert found == ["aes_s5"] and exact
    summary["aes"] = {"found": found, "rerouted_exact": exact,
                      "one_fault_pct_of_sw": pct}
    print("OK: all three case studies detect, quarantine, and recover.")
    return summary


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    main(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
