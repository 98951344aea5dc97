"""Quickstart: fault-tolerant LM training end to end, on the port.

Trains a reduced gemma2-family model on the synthetic Markov corpus,
injects a non-transient fault into the attention stage mid-run (step 60
of the default 120), and shows the Oobleck response: the stage is
quarantined onto its SW oracle, the loss trajectory is identical,
training never stops.  Training differentiates the SW route only (the
Hopper kernels are forward-only), so on the card as on the CPU the
healthy route already *is* the SW oracle: the RoutingPlan is unchanged
and the plan-keyed dispatcher dedupes the reconfiguration to zero builds
(one build in all).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
      [--steps N]
"""
import argparse
import tempfile

import numpy as np

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.train import TrainConfig, TrainRunner


def main(device=None, steps: int = 120) -> dict:
    """Train ``steps`` steps (the fault at ``steps // 2``, the canary
    every ``steps // 3``, a checkpoint every ``steps * 5 // 24``: 60, 40
    and 25 at the default) on ``device`` (default: the card)."""
    dev = resolve_device(device)
    cfg = get_config("gemma2-2b").reduced()
    print(f"arch: {cfg.name} ({cfg.num_layers}L d={cfg.d_model}) on {dev}")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                  seq_len=64))
    fault_step = steps // 2
    with tempfile.TemporaryDirectory() as ckpt_dir:
        runner = TrainRunner(
            cfg,
            optim.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=steps),
            TrainConfig(steps=steps, ckpt_every=max(1, steps * 5 // 24),
                        ckpt_dir=ckpt_dir, canary_every=max(1, steps // 3)),
            data, device=dev)
        params, opt, err = runner.init_state()

        def log(step, row):
            if step % 20 == 0:
                print(f"  step {step:4d} loss {row['loss']:.4f} "
                      f"faults={row['n_faults']} "
                      f"compiles={row['compiles']}")
            if step == fault_step:
                print("  !! non-transient fault detected in "
                      "'flash_attention' -> quarantining (SW fallback)")
                runner.inject_fault("flash_attention")

        runner.run(params, opt, err, on_step=log)
        losses = [h["loss"] for h in runner.history]
        decreasing = bool(np.mean(losses[-10:]) < np.mean(losses[:10]))
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(decreasing: {decreasing})")
        print(f"reconfigurations (compiles): {runner.dispatcher.compiles} "
              "(fault plan == healthy plan on the SW training route: "
              "deduped)")
        print(f"fault log: {runner.fault_state.log}")
        assert runner.dispatcher.compiles == 1
        assert runner.signature().faulty() == {"flash_attention"}
        assert np.isfinite(losses).all()
        print("OK: training survived a mid-run stage fault.")
        return {"arch": cfg.name, "device": str(dev), "steps": steps,
                "fault_step": fault_step, "losses": losses,
                "decreasing": decreasing,
                "compiles": runner.dispatcher.compiles,
                "faulty": sorted(runner.signature().faulty()),
                "fault_log": list(runner.fault_state.log)}


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    main(device=args.device, steps=args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
