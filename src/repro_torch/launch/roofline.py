"""Roofline analysis over the port's dry-run records (reference
``src/repro/launch/roofline.py``), for the NVIDIA H100 SXM.

Per (arch x shape x mesh) cell:

    compute term    = flops_per_device / 989 TFLOP/s            (bf16 dense)
    memory term     = bytes_per_device / 3.35 TB/s              (HBM3)
    collective term = collective_bytes_per_device / 450 GB/s    (NVLink 4)

All three inputs are per-device quantities of the sharded program, counted
shape-only by ``launch/graph_analysis.py`` in ``launch/dryrun.py``. The
step-time bound is T* = max(terms); the roofline fraction is

    frac = (MODEL_FLOPS / devices / PEAK) / T*

i.e. the best-achievable useful-FLOP utilisation of the program: waste
(remat, replicated compute from unshardable reshapes) shows up as
MODEL_FLOPS/flops < 1.

``quantum_cost`` counts one served quantum of the live engine
(``exit_decision`` at exit e on B prompts) shape-only on a one-device
mesh, ``terms`` applies the same three terms to it, and
``roofline_profile`` turns them into the L(m, e, B) table the scheduler
reads (``ProfileTable.from_roofline``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      --artifacts artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.profile import ProfileTable
from repro_torch.launch.graph_analysis import CostCounter
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


def analyze_record(rec: dict) -> Optional[dict]:
    if "error" in rec or "skipped" in rec:
        return None
    n_dev = rec["num_devices"]
    flops = rec["hlo_metrics"]["flops"]
    nbytes = rec["hlo_metrics"]["bytes"]
    coll = rec["collectives"]["bytes"]["total"]

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = coll / LINK_BW
    t_star = max(compute_s, memory_s, collective_s, 1e-12)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    model_flops_dev = rec["model_flops"] / n_dev
    useful_ratio = rec["model_flops"] / max(flops * n_dev, 1e-9)
    frac = (model_flops_dev / PEAK_FLOPS_BF16) / t_star

    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "kind": rec["kind"],
        "mesh": "x".join(str(x) for x in rec["mesh"]),
        "variant": rec.get("serve_variant", "baseline"),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "t_star": t_star,
        "dominant": dominant,
        "model_flops": rec["model_flops"],
        "useful_ratio": useful_ratio,
        "roofline_frac": frac,
        "static_gib": rec["bytes_per_device_static"] / 2**30,
        "advice": advice(dominant, useful_ratio, rec),
    }


def advice(dominant: str, useful_ratio: float, rec: dict) -> str:
    """One sentence on what would move the dominant term down."""
    kind = rec["kind"]
    if useful_ratio < 0.25 and dominant == "compute":
        return ("compute-bound but <25% useful FLOPs — replicated/redundant "
                "compute from unshardable head/reshape dims or remat; fix "
                "the sharding of the offending einsum")
    if dominant == "compute":
        return ("compute-bound near the useful-FLOP ceiling — gains come "
                "from kernel fusion (flash attention) and skipping masked "
                "work, not layout")
    if dominant == "memory":
        if kind == "decode":
            return ("HBM-bound on KV/state streaming — shrink the cache "
                    "(MLA latent/quantised KV) or batch more decode streams "
                    "per weight pass")
        return ("HBM-bound — increase arithmetic intensity: larger per-chip "
                "tiles, bf16 everywhere, fuse elementwise chains into the "
                "matmuls")
    return ("collective-bound — re-shard to cut the largest all-gather "
            "(FSDP prefetch overlap, or move TP to the axis with the "
            "smaller activation), and overlap collectives with compute")


def load_cells(artifacts: str, mesh_dir: str) -> List[dict]:
    out = []
    d = os.path.join(artifacts, mesh_dir)
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(d, name)) as f:
            rec = json.load(f)
        row = analyze_record(rec)
        if row is not None:
            row["_file"] = name
            out.append(row)
    return out


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def markdown_table(rows: List[dict]) -> str:
    hdr = ("| arch | shape | kind | compute | memory | collective | bound | "
           "useful | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.2%} |"
        )
    return hdr + "\n".join(lines) + "\n"


def quantum_cost(model, exit_idx: int, batch_size: int, prompt_len: int,
                 mesh) -> CostCounter:
    """Count one served quantum, ``model.exit_decision`` at ``exit_idx`` on
    the served batch (``runtime/server.py::lm_payload``) of ``batch_size``
    prompts of ``prompt_len`` tokens, shape-only: ``model`` is a build on
    ``meta``, and its parameters and batch are replicated ``DTensor``s on
    ``mesh`` (a one-device mesh counts what one card runs)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.models.common import meta_generator, set_params
    from repro_torch.runtime.server import lm_payload

    rep = NamedSharding(mesh, ())
    batch = {k: rep.shard_meta(v) for k, v in lm_payload(
        model.cfg, meta_generator(), prompt_len, batch_size).items()}
    saved = dict(model.named_parameters())
    counter = CostCounter()
    try:
        set_params(model, {k: rep.shard_meta(p) for k, p in saved.items()})
        with torch.no_grad(), counter, implicit_replication():
            model.exit_decision(batch, exit_idx)
    finally:
        set_params(model, saved)
    return counter


def terms(counter: CostCounter) -> Tuple[float, float, float]:
    """(compute_s, memory_s, collective_s) of a count on one card."""
    return (counter.flops / PEAK_FLOPS_BF16, counter.bytes / HBM_BW,
            counter.collectives()["bytes"]["total"] / LINK_BW)


def roofline_profile(configs: Mapping[str, object],
                     batch_sizes: Sequence[int], prompt_len: int, mesh,
                     exit_names: Optional[Sequence[str]] = None, **kwargs) -> Tuple[ProfileTable, dict]:
    """The roofline L(m, e, B) table of the served LMs (one per config, in
    order, built on ``meta``, counted on ``mesh`` by ``quantum_cost``) and
    the counts behind it, ``{(m, e, B):
    {"flops", "bytes", "collective_bytes", "compute_s", "memory_s",
    "collective_s", "t_star"}}``. ``kwargs`` go to
    ``ProfileTable.from_roofline``."""
    from repro_torch.models import build_model

    names = list(configs)
    models = [build_model(configs[n], device="meta").eval() for n in names]
    n_exits = models[0].cfg.num_exits
    exit_names = tuple(exit_names or (f"exit{e}" for e in range(n_exits)))
    counts = {}
    for mi, model in enumerate(models):
        for e in range(len(exit_names)):
            for b in batch_sizes:
                c = quantum_cost(model, e, b, prompt_len, mesh=mesh)
                t = terms(c)
                counts[(mi, e, b)] = {
                    "flops": c.flops, "bytes": c.bytes,
                    "collective_bytes": c.collectives()["bytes"]["total"],
                    "compute_s": t[0], "memory_s": t[1],
                    "collective_s": t[2], "t_star": max(t)}
    table = ProfileTable.from_roofline(
        names, exit_names, batch_sizes,
        lambda m, e, b: (counts[(m, e, b)]["compute_s"],
                         counts[(m, e, b)]["memory_s"],
                         counts[(m, e, b)]["collective_s"]),
        meta={"platform": "h100-sxm-roofline", "prompt_len": prompt_len},
        **kwargs)
    return table, counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun_torch")
    ap.add_argument("--out", default="artifacts/roofline_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for mesh_dir in ("single", "multi"):
        rows = load_cells(args.artifacts, mesh_dir)
        if not rows:
            continue
        md = markdown_table(rows)
        with open(os.path.join(args.out, f"roofline_{mesh_dir}.md"), "w") as f:
            f.write(md)
        with open(os.path.join(args.out, f"roofline_{mesh_dir}.json"), "w") as f:
            json.dump(rows, f, indent=1)
        print(f"== {mesh_dir} ==")
        print(md)
        for r in rows:
            print(f"  {r['arch']}/{r['shape']}: {r['advice']}")


if __name__ == "__main__":
    main()
