"""Find a configuration's knee on the card.

    python bench/sweep.py --config dense_pair \
        --rates 300,350,400,450,500,550,600,650,700 --seconds 12 --seeds 7,8

Each seed is one sweep in a process of its own: its own deployment, its
own offline profile, then at each rate a fresh engine and scheduler serve
the ``steady`` mix's generator at ``load`` 1 for ``--seconds``, without a
drain, so that what is queued at the end is counted. One JSON line per
seed and rate, then the knee: the highest rate at and below which, in
every sweep, at least ``MIN_MET_SHARE`` of the window's requests finished
within the SLO and no queue held more than one B_max batch at the end.
The cells run at their traffic's ``load`` times the knee, which goes into
the configuration's file as ``knee_req_s``.

``MIN_MET_SHARE`` is 0.93, not 0.99: Eq. 6 packs each batch to its
profiled P95, so some quanta overrun at any load, and the share in time
swings between 93% and 99% from one rate to the next with no trend below
the rate at which queues build. At 0.99 no rate passes in two sweeps.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MIN_MET_SHARE = 0.93


def within(row: dict, max_batch: int,
           min_share: float = MIN_MET_SHARE) -> bool:
    """One sweep's window at one rate kept the load."""
    return (row["met_share"] >= min_share
            and max(row["queues_at_end"]) <= max_batch)


def knee(sweeps: Sequence[Sequence[dict]], max_batch: int,
         min_share: float = MIN_MET_SHARE) -> Optional[float]:
    """The highest rate at and below which every sweep's window kept the
    load; ``None`` when the lowest rate does not."""
    rates = sorted({r["rate_req_s"] for rows in sweeps for r in rows})
    best = None
    for rate in rates:
        rows = [r for rows in sweeps for r in rows if r["rate_req_s"] == rate]
        if len(rows) < len(sweeps) or not all(
                within(r, max_batch, min_share) for r in rows):
            break
        best = rate
    return best


def sweep_one(config: dict, rates: List[float], seconds: float,
              seed: int) -> int:
    """One sweep in this process: a JSON line per rate."""
    import torch

    from harness import deploy, summary
    from harness import traffic as traffic_gen
    from repro_torch.core import SchedulerConfig, make_scheduler
    from repro_torch.runtime.server import ServingEngine, measure_profile

    if not torch.cuda.is_available():
        print("the sweep measures the card; there is none", file=sys.stderr)
        return 2
    steady = json.loads((BENCH / "traffic" / "steady.json").read_text())
    steady = dict(steady, load=1.0)
    slo, bmax = config["slo_ms"] * 1e-3, config["max_batch"]
    dep = deploy.build(config, seed, torch.device("cuda", 0))
    n_exits = dep.served[0].num_exits
    table = measure_profile(dep.served, batch_sizes=config["profile_batches"],
                            exit_names=[f"exit{e}" for e in range(n_exits)])
    print(json.dumps({"seed": seed,
                      "profile_ms": (table.latency * 1e3).tolist()}))
    for rate in rates:
        sched = make_scheduler("edgeserving", table, SchedulerConfig(
            slo=slo, max_batch=bmax, backend="cuda"))
        engine = ServingEngine(dep.served, sched)
        engine.warmup()
        split = traffic_gen.model_rates(
            steady, rate, [m["share"] for m in config["models"]])
        arrivals = traffic_gen.arrivals(steady, split, seconds, seed)
        t0 = time.perf_counter()
        done, _ = engine.run(arrivals, seconds, drain=False)
        lat = [c.finish - c.arrival for c in done]
        s = summary.summarize(len(arrivals), lat,
                              [c.dispatch - c.arrival for c in done],
                              [c.exit_idx for c in done],
                              [c.batch_size for c in done],
                              [slo] * len(done), seconds)
        row = {"seed": seed, "rate_req_s": rate,
               "met_share": s["met_deadline"] / max(len(arrivals), 1),
               "queues_at_end": [len(q) for q in engine.queues],
               "wall_s": time.perf_counter() - t0,
               **{k: s.get(k) for k in ("p95_ms", "mean_exit_depth",
                                        "mean_batch", "goodput_req_s",
                                        "offered_req_s")}}
        row["within"] = within(row, bmax)
        print(json.dumps(row), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seeds", default="7,8")
    ap.add_argument("--one", action="store_true",
                    help="run the one sweep of --seeds in this process")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}[args.config]
    config = json.loads((ROOT / entry["file"]).read_text())
    rates = [float(r) for r in args.rates.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.one:
        return sweep_one(config, rates, args.seconds, seeds[0])

    sweeps = []
    for seed in seeds:
        out = subprocess.run(
            [sys.executable, __file__, "--config", args.config, "--rates",
             args.rates, "--seconds", str(args.seconds), "--seeds", str(seed),
             "--one"], stdout=subprocess.PIPE, text=True)
        sys.stdout.write(out.stdout)
        sys.stdout.flush()
        if out.returncode:
            return out.returncode
        sweeps.append([json.loads(line) for line in out.stdout.splitlines()
                       if line.startswith("{") and '"rate_req_s"' in line])
    print(json.dumps({"config": args.config, "seeds": seeds,
                      "min_met_share": MIN_MET_SHARE,
                      "knee_req_s": knee(sweeps, config["max_batch"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
