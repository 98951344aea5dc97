"""Paper §II / Fig. 2: data-center fleet simulation CLI, on the port.

Analytic / Monte-Carlo sweep (the Fig. 2 math):
    PYTHONPATH=src python examples_torch/datacenter_sim.py [--mc]
        [--device cpu]

The sweep is host arithmetic (``core/datacenter.py``, numpy); the device
is resolved as in the other examples, so it runs on a machine with the
card unless ``--device cpu`` is given, and it is recorded in the summary.

``--replay`` (a Monte-Carlo fault trace replayed through the real
``FleetServeEngine``) drives the reference's ``benchmarks/fleet_bench.py``,
which the port does not have yet: it waits for the port's benchmark.  It
prints that and exits with code 2; nothing stands in for it.
"""
import argparse

from repro_torch.core.datacenter import chips_to_buy, fig2_sweep
from repro_torch.core.latency import fft_model, throughput_factor
from repro_torch.device import resolve_device

RATES = [1e-2, 1e-3, 1e-4, 1e-5, 1e-6]
REPLAY_EXIT = 2


def main(device=None, *, chips: int = 10_000, ticks: int = 1460,
         mc: bool = False) -> dict:
    """The Fig. 2 sweep; returns its rows, the degradation curve and the
    purchases."""
    dev = resolve_device(device)
    deg = tuple(throughput_factor(fft_model(), k) for k in range(3))
    print(f"VFA degradation curve (FFT case study): "
          f"{[round(d, 3) for d in deg]}")
    print(f"{'p/tick':>10} {'SFA repl':>12} {'VFA repl':>12} "
          f"{'SFA tput':>9} {'VFA tput':>9}")
    rows = fig2_sweep(RATES, n_chips=chips, ticks=ticks, degradation=deg,
                      monte_carlo=mc)
    for p, sr, vr, st, vt in rows:
        print(f"{p:>10.0e} {sr:>12.1f} {vr:>12.4f} {st:>9.4f} {vt:>9.4f}")
    print("\nFixed-throughput purchases (100 faulted chips):")
    buys = {}
    for name, r in [("SFA (lose all)", 0.0), ("half perf kept", 0.5),
                    ("1/3 perf lost", 2 / 3)]:
        buys[name] = chips_to_buy(100, r)
        print(f"  {name:>16}: buy {buys[name]:.1f} chips")
    print("OK: the Fig. 2 sweep ran.")
    return {"device": str(dev), "degradation": deg,
            "rows": [tuple(r) for r in rows], "chips_to_buy": buys}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mc", action="store_true", help="Monte-Carlo mode")
    ap.add_argument("--replay", action="store_true",
                    help="replay a fault trace through the real engines "
                         "(waits for the port's fleet benchmark)")
    ap.add_argument("--chips", type=int, default=10_000)
    ap.add_argument("--ticks", type=int, default=1460)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    if args.replay:
        print("datacenter_sim --replay: the replay drives the fleet "
              "benchmark (benchmarks/fleet_bench.py in the reference), "
              "which the port does not have yet; it waits for the port's "
              "benchmark")
        return REPLAY_EXIT
    main(device=args.device, chips=args.chips, ticks=args.ticks,
         mc=args.mc)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
