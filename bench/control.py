"""Readings for the limits of ``correct``: the program's on many seeds and
the control's (the plain reference through float8 in the program's place)
on the first few, from short windows at the cell's own load, in one
process.

    python bench/control.py --workload dense_pair.steady \
        --seeds 11,12,13 --control 3 --seconds 6

One JSON line per seed: the program's numbers, and where asked the
control's, beside the limits in the configuration's file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds also read the control")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

    import gc

    import torch

    from harness.cell import run_cell
    from run import load_spec

    if not torch.cuda.is_available():
        print("the control runs on the card; there is none",
              file=sys.stderr)
        return 2
    _, cell, config, traffic = load_spec(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = run_cell(config, traffic, seed, args.seconds, False,
                       torch.device("cuda", 0), time.perf_counter(),
                       control=i < args.control)
        print(json.dumps({
            "workload": cell["name"], "seed": seed,
            "program": {n: v for n, v, _ in rec.checks},
            "control": rec.control, "limits": config["limits"],
            "correct": rec.correct, "control_correct": rec.control_correct,
            "rows": rec.sample_rows, "completed": rec.summary["completed"],
            "p95_ms": rec.summary.get("p95_ms"),
            "mean_exit_depth": rec.summary.get("mean_exit_depth")}),
            flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
