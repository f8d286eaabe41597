"""The port's dry-run over every applicable (arch x shape) cell of one
production mesh, several cells at a time, each under a time limit.

Each worker process builds the mesh (``launch/mesh.py``, a fake process
group) and lowers its cells with ``launch/dryrun.py::lower_cell``; a cell
that raises or runs past ``--limit`` seconds is reported with its error
and where it arose. One JSON line a cell goes to stdout and to
``--out``; the last line counts the cells that lowered.

    PYTHONPATH=src python tools/dryrun_matrix.py --mesh single --jobs 4
    PYTHONPATH=src python tools/dryrun_matrix.py --mesh multi --limit 90 \\
        --skip jamba-v0.1-52b:train_4k,jamba-v0.1-52b:prefill_32k
    PYTHONPATH=src python tools/dryrun_matrix.py --layers 2   # depth-cut
    PYTHONPATH=src python tools/dryrun_matrix.py --arch rwkv6-1.6b
    PYTHONPATH=src python tools/dryrun_matrix.py --mesh multi \\
        --cells jamba-v0.1-52b:long_500k,smollm-135m:train_4k
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/dryrun_matrix.py \
        --reference --jobs 2 --out chiprun_out/dryrun_matrix_ref.jsonl

It needs no card: the counts are shape-only, on the CPU. ``--reference``
lowers the same cells with the reference's ``repro/launch/dryrun.py::
lower_cell`` instead, each in a subprocess of its own (512 host devices in
its ``XLA_FLAGS``) killed at the limit; that needs JAX, so not the card
machine.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import signal
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


_REFERENCE = """
import json, sys
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
arch, shape, multi, layers = sys.argv[1], sys.argv[2], sys.argv[3] == "1", int(sys.argv[4])
overrides = {"num_layers": layers, "exits": (layers // 2, layers)} if layers else None
rec = dryrun.lower_cell(arch, shape, make_production_mesh(multi_pod=multi),
                        multi, overrides=overrides)
print(json.dumps({"flops": rec["hlo_metrics"]["flops"],
                  "collective_bytes": rec["collectives"]["bytes"]["total"],
                  "num_devices": rec["num_devices"],
                  "model_flops": rec["model_flops"],
                  "static": rec["bytes_per_device_static"]}))
"""


def lower_reference(job):
    """One cell lowered by the reference in a subprocess: its summary, or
    the subprocess's error or time-out."""
    import subprocess

    arch, shape, multi, layers, limit = job
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    row = {"cell": f"{arch}:{shape}"}
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-c", _REFERENCE, arch, shape, str(int(multi)),
             str(layers)], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=limit)
        if out.returncode:
            row.update(ok=False, error=out.stderr.strip()[-240:])
        else:
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            row.update(ok=True, flops=rec["flops"],
                       collective_bytes=rec["collective_bytes"],
                       flops_over_model=(rec["flops"] * rec["num_devices"]
                                         / rec["model_flops"]),
                       static_gib=rec["static"] / 2**30)
    except subprocess.TimeoutExpired:
        row.update(ok=False, error=f"TimeoutError: over {limit} s")
    row["seconds"] = time.perf_counter() - t0
    return row


def lower(job):
    """One cell: its summary, or its error and the port's frames in it."""
    arch, shape, multi, layers, limit = job
    import torch

    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh, release_mesh

    torch.set_num_threads(2)

    def over(*_):
        raise TimeoutError(f"over {limit} s")

    # the alarm repeats each second past the limit: a reshape's fallback
    # in the cost counter may catch the first one wrapped in DTensor's
    # RuntimeError and carry on
    signal.signal(signal.SIGALRM, over)
    overrides = ({"num_layers": layers, "exits": (layers // 2, layers)}
                 if layers else None)
    t0 = time.perf_counter()
    row = {"cell": f"{arch}:{shape}"}
    try:
        mesh = make_production_mesh(multi_pod=multi)
        signal.setitimer(signal.ITIMER_REAL, limit, 1.0)
        rec = lower_cell(arch, shape, mesh, multi, overrides=overrides)
        signal.setitimer(signal.ITIMER_REAL, 0)
        row.update(ok=True, flops=rec["hlo_metrics"]["flops"],
                   collective_bytes=rec["collectives"]["bytes"]["total"],
                   flops_over_model=(rec["hlo_metrics"]["flops"]
                                     * rec["num_devices"]
                                     / rec["model_flops"]),
                   static_gib=rec["bytes_per_device_static"] / 2**30)
    except BaseException as err:   # a cell that fails is a result
        signal.setitimer(signal.ITIMER_REAL, 0)
        frames = traceback.extract_tb(err.__traceback__)
        row.update(ok=False, error=f"{type(err).__name__}: {str(err)[:240]}",
                   where=[f"{Path(f.filename).name}:{f.lineno}"
                          for f in frames if "repro_torch" in f.filename][-3:])
    finally:
        release_mesh()
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--limit", type=int, default=150,
                    help="seconds a cell may run")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every cell to this depth (0: full)")
    ap.add_argument("--skip", default="", help="arch:shape,... to leave out")
    ap.add_argument("--arch", default="",
                    help="arch,... to keep (default: every arch)")
    ap.add_argument("--cells", default="",
                    help="arch:shape,... to keep (default: every cell)")
    ap.add_argument("--out", default="chiprun_out/dryrun_matrix.jsonl")
    ap.add_argument("--reference", action="store_true",
                    help="lower with the reference's lower_cell (needs JAX)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch.dryrun import list_cells

    skip = set(filter(None, args.skip.split(",")))
    keep = set(filter(None, args.cells.split(",")))
    archs = [a for a in args.arch.split(",") if a] or list(ARCH_IDS)
    jobs = [(c[0], c[1], args.mesh == "multi", args.layers, args.limit)
            for c in list_cells(archs, list(SHAPES))
            if len(c) == 2 and f"{c[0]}:{c[1]}" not in skip
            and (not keep or f"{c[0]}:{c[1]}" in keep)]
    print(json.dumps({"torch": torch.__version__, "mesh": args.mesh,
                      "cells": len(jobs), "reference": args.reference}),
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ok = 0
    with mp.get_context("spawn").Pool(args.jobs) as pool, \
            open(args.out, "w") as fh:
        for row in pool.imap_unordered(
                lower_reference if args.reference else lower, jobs):
            ok += row["ok"]
            line = json.dumps(row)
            fh.write(line + "\n")
            fh.flush()
            print(line, flush=True)
    print(json.dumps({"lowered": ok, "of": len(jobs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
