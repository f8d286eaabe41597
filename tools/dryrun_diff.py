"""Where the port's dry-run count of one cell and the reference's part
ways, op by op.

For one (arch, shape, mesh) cell, every width full and the depth cut to
``--layers``, it prints both per-device counts broken down:

* the reference's, from its optimised HLO: ``repro/launch/dryrun.py::
  lower_cell`` runs in a subprocess with the reference's ``XLA_FLAGS``
  (512 host devices), as ``tests/test_torch_dryrun_reference*.py`` run
  it; dot flops by their ``op_name`` metadata (``jvp`` the forward,
  ``transpose(jvp)`` the backward, none for the attention's einsums) and
  result shape, weighted through the while loops by their trip counts,
  and collective bytes by kind;
* the port's, from ``launch/graph_analysis.py::CostCounter(ledger=True)``
  through ``launch/dryrun.py::lower_cell``: flops by phase (``fw``, or
  the backward node that ran the op), the kernel or partition rule that
  billed it, aten op and result shape; collective bytes by phase, rule
  and kind.

Then the totals side by side: flops, collective bytes and static bytes a
device, and the port's over the reference's.

    PYTHONPATH=src python tools/dryrun_diff.py --arch qwen3-8b \\
        --shape train_4k --layers 2
    PYTHONPATH=src python tools/dryrun_diff.py --arch jamba-v0.1-52b \\
        --shape train_4k --layers 2 --exits 2 --set attn_period=2 \\
        --set attn_offset=1 --top 40

It needs no card; the reference side needs JAX, which the card machine
lacks: ``--no-reference`` prints the port's side alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

def reference_dots(hlo: str) -> dict:
    """Dot flops of the reference's optimised HLO text, by ``op_name``
    (its ``jit(...)/`` prefix cut) and result shape, each weighted
    through the while loops by their trip counts as
    ``repro/launch/hlo_analysis.py::hlo_metrics`` weights them. Reads the
    text only: JAX need not be imported."""
    import re

    from repro.launch import hlo_analysis as H

    comps = H._split_computations(hlo)
    calls = {}
    for name, lines in comps.items():
        out = []
        for line in lines:
            d = H._DEF_RE.match(line)
            m = d and re.search(r"\b([\w\-]+)\(", d.group(2))
            if not m:
                continue
            rest = d.group(2)
            if m.group(1) == "while":
                body, trip = H._BODY_RE.search(rest), H._TRIP_RE.search(rest)
                if body:
                    out.append((body.group(1),
                                int(trip.group(1)) if trip else 1))
            elif m.group(1) in ("fusion", "call", "conditional", "map",
                                "reduce", "reduce-window", "sort", "scatter",
                                "select-and-scatter"):
                out += [(c, 1) for c in re.findall(
                    r"(?:calls|to_apply|branch_computations)=\{?%?([\w.\-]+)",
                    rest)]
        calls[name] = out
    weight = {}

    def walk(name, w, stack=()):
        if name in stack or name not in comps:
            return
        weight[name] = weight.get(name, 0) + w
        for callee, trip in calls[name]:
            walk(callee, w * trip, stack + (name,))

    walk("__entry__", 1)
    dots = {}
    for name, lines in comps.items():
        w = weight.get(name, 0)
        if not w:   # the entry under its own name is walked as "__entry__"
            continue
        shapes = {}
        for line in lines:
            d = H._DEF_RE.match(line)
            m = d and re.search(r"\b([\w\-]+)\(", d.group(2))
            if not m:
                continue
            rest = d.group(2)
            shapes[d.group(1)] = H._SHAPE_RE.findall(rest[:m.start()])
            if m.group(1) != "dot" or not shapes[d.group(1)]:
                continue
            size = 1
            for _, dims in shapes[d.group(1)]:
                for n in filter(None, dims.split(",")):
                    size *= int(n)
            operands = H._OPND_RE.findall(
                rest[m.end():rest.find(")", m.end())])
            contract = 1
            cm = H._LHS_CONTRACT_RE.search(rest)
            lhs = shapes.get(operands[0], []) if operands else []
            if cm and lhs:
                dims = lhs[0][1].split(",") if lhs[0][1] else []
                for i in filter(None, cm.group(1).split(",")):
                    if int(i) < len(dims):
                        contract *= int(dims[int(i)])
            op = re.search(r'op_name="([^"]*)"', rest)
            op = op.group(1).split("/", 1)[-1] if op else "(no op_name)"
            dtype, dims = shapes[d.group(1)][0]
            key = op + " " + dtype + "[" + dims + "]"
            dots[key] = dots.get(key, 0.0) + w * 2.0 * size * contract
    return dots


# The reference's side, in a subprocess: lower_cell with its hlo_metrics
# wrapped to keep the optimised HLO, then that text's dots.
_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[5])
from dryrun_diff import reference_dots
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh

arch, shape, mesh_name, overrides = sys.argv[1:5]
overrides = json.loads(overrides)
if "exits" in overrides:
    overrides["exits"] = tuple(overrides["exits"])
kept = {}
metrics = dryrun.hlo_metrics
dryrun.hlo_metrics = lambda text: kept.setdefault("hlo", text) and metrics(text)
multi = mesh_name == "multi"
rec = dryrun.lower_cell(arch, shape, make_production_mesh(multi_pod=multi),
                        multi, overrides=overrides)
dots = reference_dots(kept["hlo"])
print(json.dumps({"flops": rec["hlo_metrics"]["flops"],
                  "collectives": rec["collectives"]["bytes"],
                  "static": rec["bytes_per_device_static"],
                  "dots": sorted(dots.items(), key=lambda kv: -kv[1])}))
"""


def overrides_of(args) -> dict:
    out = {}
    if args.layers:
        out["num_layers"] = args.layers
        out["exits"] = [args.layers // 2, args.layers]
    if args.exits:
        out["exits"] = [int(e) for e in args.exits.split(",")]
    for item in args.set:
        key, value = item.split("=", 1)
        out[key] = int(value) if value.lstrip("-").isdigit() else value
    return out


def reference(args, overrides: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, args.arch, args.shape, args.mesh,
         json.dumps(overrides), str(ROOT / "tools")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def port(args, overrides: dict) -> dict:
    import torch

    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh, release_mesh

    torch.set_num_threads(4)
    multi = args.mesh == "multi"
    try:
        rec = lower_cell(args.arch, args.shape,
                         make_production_mesh(multi_pod=multi), multi,
                         overrides={k: tuple(v) if k == "exits" else v
                                    for k, v in overrides.items()},
                         ledger=True)
    finally:
        release_mesh()
    return rec


def table(title: str, rows, total: float, top: int) -> None:
    print(f"-- {title}: {total:.6e}")
    for *key, value in sorted(rows, key=lambda r: -r[-1])[:top]:
        share = 100.0 * value / total if total else 0.0
        print(f"{value:14.6e} {share:6.2f}%  " + "  ".join(map(str, key)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--layers", type=int, default=2,
                    help="cut the depth to this (0: full depth)")
    ap.add_argument("--exits", default="",
                    help="exits, comma-separated (default: layers/2,layers)")
    ap.add_argument("--set", action="append", default=[],
                    help="another LMConfig override, key=value")
    ap.add_argument("--top", type=int, default=25, help="rows a table")
    ap.add_argument("--no-reference", action="store_true")
    args = ap.parse_args(argv)
    overrides = overrides_of(args)
    print(json.dumps({"cell": f"{args.arch}:{args.shape}:{args.mesh}",
                      "overrides": overrides}))

    ref = None if args.no_reference else reference(args, overrides)
    if ref is not None:
        table("reference dots (op_name, result)",
              [[k, v] for k, v in ref["dots"]], ref["flops"], args.top)
        table("reference collective bytes",
              [[k, v] for k, v in ref["collectives"].items()
               if k != "total"], ref["collectives"]["total"], args.top)
    rec = port(args, overrides)
    flops = rec["hlo_metrics"]["flops"]
    coll = rec["collectives"]["bytes"]["total"]
    table("port flops (phase, rule, op, result)", rec["ledger"]["flops"],
          flops, args.top)
    table("port collective bytes (phase, rule, kind)",
          rec["ledger"]["collectives"], coll, args.top)
    totals = {"port": {"flops": flops, "collective_bytes": coll,
                       "static": rec["bytes_per_device_static"]}}
    if ref is not None:
        totals["reference"] = {"flops": ref["flops"],
                               "collective_bytes": ref["collectives"]["total"],
                               "static": ref["static"]}
        totals["port_over_reference"] = {
            "flops": flops / ref["flops"],
            "collective_bytes": coll / ref["collectives"]["total"],
            "static": rec["bytes_per_device_static"] / ref["static"]}
    print(json.dumps(totals))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
