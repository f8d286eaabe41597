"""Serving CLI: simulate a paper-style serving experiment from the CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --scheduler edgeserving \
      --lam 200 --slo-ms 50 --platform rtx3080
  PYTHONPATH=src python -m repro_torch.launch.serve --all   # every policy

The flags and the printed lines are the reference's
(``src/repro/launch/serve.py``). The schedulers score with the default
``numpy`` backend, so the run stays on the host and its lines are the
reference's, digit for digit.
"""

from __future__ import annotations

import argparse
from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    make_scheduler,
    paper_rate_vector,
    run_experiment,
)

PLATFORMS = {
    "rtx3080": ProfileTable.paper_rtx3080,
    "gtx1650": ProfileTable.paper_gtx1650,
    "jetson": ProfileTable.paper_jetson_orin_nano,
}


def one(name, table, lam, slo, horizon, seed):
    cfg = SchedulerConfig(slo=slo, max_batch=10)
    res = run_experiment(make_scheduler(name, table, cfg), table,
                         paper_rate_vector(lam), horizon=horizon, seed=seed)
    m = res.metrics
    print(f"{name:24s} lam={lam:4.0f}: P95={m.p95_latency*1e3:8.2f}ms "
          f"viol={m.violation_ratio*100:6.2f}% acc={m.mean_accuracy*100:5.2f}% "
          f"depth={m.mean_exit_depth:.2f} dropped={m.dropped}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="edgeserving")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lam", type=float, default=200.0)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--platform", default="rtx3080", choices=list(PLATFORMS))
    ap.add_argument("--horizon", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    table = PLATFORMS[args.platform]()
    scheds = (
        ("edgeserving", "all-final", "all-early", "symphony",
         "earlyexit-lqf", "earlyexit-edf", "allfinal-deadline-aware",
         "ours-bs1")
        if args.all else (args.scheduler,)
    )
    for s in scheds:
        one(s, table, args.lam, args.slo_ms * 1e-3, args.horizon, args.seed)


if __name__ == "__main__":
    main()
