"""Run one cell of the port's benchmark once.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration (its file under ``bench/configs/``) and a traffic mix
(``bench/traffic/<traffic>.json``); each metric is read by
``bench/metrics/<metric>.py``. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics: those
of the host's clock read from the window as in a ``--trace 0`` run, those
of the device from a profiled stretch served after it.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error). With no card, or fewer than the
cell asks for, it exits 2 and prints no result; if JAX or the JAX package
is loaded once the window has closed, it exits 3.

Kernels are built into the checkout's ``build/kernels/`` by the port (the
first run compiles them); other kernel caches are pointed into
``build/`` too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(workload: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return spec, cell, config, traffic


def metric_reader(entry: dict):
    """The module of ``bench/metrics/<name>.py``, checked against its
    entry in ``BENCHMARK.json``."""
    name = entry["name"]
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    for key, attr in (("unit", "UNIT"), ("better", "BETTER"),
                      ("source", "SOURCE"), ("layer", "LAYER"),
                      ("moves", "MOVES")):
        if entry.get(key) != getattr(mod, attr):
            raise SystemExit(f"metric {name}: {key} is {entry.get(key)!r} "
                             f"in BENCHMARK.json, {getattr(mod, attr)!r} "
                             f"in {path.name}")
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def card_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec, cell, config, traffic = load_spec(args.workload)
    group = spec["per_layer"] if args.trace else spec["end_to_end"]
    readers = [(e, metric_reader(e)) for e in group
               if applies(e, cell["name"])]
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from harness.cell import run_cell

    device = torch.device("cuda", 0)
    rec = run_cell(config, traffic, args.seed, args.seconds,
                   bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3

    s = rec.summary
    card = card_limit()
    print(json.dumps({"cell": cell["name"], "seed": args.seed,
                      "card_and_power_limit": card, "summary": s,
                      "per_model": rec.per_model,
                      "profile_ms_final": (rec.table.latency[:, -1, :] *
                                           1e3).tolist(),
                      "violation_ratio": s["violation_ratio"],
                      "setup_s": rec.setup_s, "profile_s": rec.profile_s,
                      "decision_us_mean": 1e6 * sum(rec.round_seconds) /
                      max(len(rec.round_seconds), 1),
                      "check_rows": rec.sample_rows}))
    metrics = {}
    for entry, mod in readers:
        value = mod.read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": rec.correct, "attempted": rec.arrivals,
           "failed": s["failed"], "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        tr = rec.trace
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        print(json.dumps({"trace": {k: tr[k] for k in (
            "quanta", "kernel_events", "kernels", "quanta_flops",
            "quanta_seconds")}}))
    out["checks"] = {name: {"value": float(v), "limit": float(lim)}
                     for name, v, lim in rec.checks}
    for name, v, lim in rec.checks:
        print(f"check {name} {float(v)!r} limit {float(lim)!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
