"""Quickstart: the EdgeServing scheduler in 40 lines, on the PyTorch port.

Builds the paper-calibrated profile table, runs one serving experiment for
EdgeServing and All-Final at high traffic, and prints the comparison the
whole paper is about. The same lines as ``examples/quickstart.py``: the
simulator and the ``numpy`` scoring backend are host numpy, op for op the
reference's.

  PYTHONPATH=src python examples_torch/quickstart.py
"""

from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    make_scheduler,
    paper_rate_vector,
    run_experiment,
)

POLICIES = ("edgeserving", "all-final", "all-early", "symphony")


def main():
    # Offline phase: the profile table L(m, e, B) (paper Sec. IV).
    table = ProfileTable.paper_rtx3080()
    print(f"profile: {table.model_names} x {table.exit_names} x "
          f"B<={table.max_batch}")

    # Online phase: 20 s of Poisson traffic at lambda_152 = 200 req/s
    # (3:2:1 rate ratio), tau = 50 ms.
    cfg = SchedulerConfig(slo=0.050, max_batch=10)
    for name in POLICIES:
        sched = make_scheduler(name, table, cfg)
        res = run_experiment(sched, table, paper_rate_vector(200),
                             horizon=20.0, seed=0)
        m = res.metrics
        print(f"{name:12s}: P95={m.p95_latency*1e3:8.2f} ms  "
              f"violations={m.violation_ratio*100:6.2f}%  "
              f"accuracy={m.mean_accuracy*100:5.2f}%  "
              f"mean_exit_depth={m.mean_exit_depth:.2f}")

    print("\nEdgeServing holds P95 under the 50 ms SLO with <1% violations "
          "by trading exit depth for queue drain rate; All-Final collapses "
          "past the saturation point (paper Fig. 4).")


if __name__ == "__main__":
    main()
