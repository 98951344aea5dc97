"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-aware TrainRunner on the arch's reduced config, or with
``--full`` the full config.  The flags and defaults are the reference
CLI's, plus ``--device``: the card (``cuda``) unless given another, e.g.
``--device cpu``.  Training differentiates the SW route only:
``--hw-route hw`` (or ``interpret``) fails on the first step with the
forward-only error.  The last stdout line is one JSON object with
``final_loss``, ``compiles`` and ``fault_log``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import optim
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.obs.logging import configure as obs_configure, get_logger
from repro_torch.train import TrainConfig, TrainRunner
from repro_torch.viscosity import HW, INTERPRET, SW

log = get_logger("launch.train")


def main(argv=None):
    obs_configure(stream=sys.stdout)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list(ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--full", action="store_true",
                    help="full config (needs the card's memory)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--canary-every", type=int, default=50)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--inject-stage", default="flash_attention")
    ap.add_argument("--hw-route", default=SW,
                    choices=[HW, SW, INTERPRET])
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card, "
                         "cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=args.batch, seq_len=args.seq))
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=20,
                             total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       canary_every=args.canary_every,
                       compression=args.compression,
                       hw_route=args.hw_route)
    runner = TrainRunner(cfg, ocfg, tcfg, data, device=device)
    params, opt_state, err = runner.init_state()

    def on_step(step, row):
        if step % 10 == 0:
            log.info("step", step=step, loss=round(row["loss"], 4),
                     gnorm=round(row["grad_norm"], 2),
                     dt_ms=round(row["dt"] * 1e3),
                     faults=row["n_faults"], compiles=row["compiles"])
        if args.inject_fault_at == step:
            log.warning("injecting_fault", stage=args.inject_stage)
            runner.inject_fault(args.inject_stage)

    runner.run(params, opt_state, err, on_step=on_step)
    sys.stdout.write(json.dumps(
        {"final_loss": runner.history[-1]["loss"],
         "compiles": runner.dispatcher.compiles,
         "fault_log": runner.fault_state.log}, default=str) + "\n")


if __name__ == "__main__":
    main()
