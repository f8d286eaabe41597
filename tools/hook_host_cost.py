"""Host time that the cost count's hooks in the model code add to a real
step, where no count is active: ``kernels/checks.py::partitioned`` (the
block of every layer loop, the MoE's experts, the cross-attention, the
cross-entropy, each exit head's unembedding), ``run_plain`` (each kernel
wrapper's plain path) and ``time_loop`` (the Mamba and WKV time loops).

Each hook is timed around a function that does nothing, against calling
that function itself, ``--calls`` calls a repeat; the figure is the
median over ``--repeats`` of the difference, in microseconds a call.

    PYTHONPATH=src python tools/hook_host_cost.py [--calls 200000]

Prints one JSON line: ``{"us_per_call": {hook: us}, "python": ...,
"torch": ..., "cpu": ...}``. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _noop(*args, **kwargs):
    return None


def _per_call(fn, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def measure(calls: int, repeats: int) -> dict:
    import torch

    from repro_torch.kernels import checks

    x = torch.zeros(4)

    def loop():
        with checks.time_loop(4) as trips:
            return trips

    hooks = {
        "partitioned": (lambda: checks.partitioned("layer", _noop, x),
                        lambda: _noop(x)),
        "run_plain": (lambda: checks.run_plain("rmsnorm", _noop, x),
                      lambda: _noop(x)),
        "time_loop": (loop, lambda: 4),
    }
    out = {}
    for name, (hooked, bare) in hooks.items():
        diffs = []
        for _ in range(repeats):
            diffs.append(_per_call(hooked, calls) - _per_call(bare, calls))
        out[name] = statistics.median(diffs)
    return {"us_per_call": out, "python": platform.python_version(),
            "torch": torch.__version__, "cpu": platform.processor()
            or platform.machine()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200_000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.calls, args.repeats)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
