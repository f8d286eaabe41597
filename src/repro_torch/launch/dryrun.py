"""Multi-pod dry-run of the port: every (architecture x input shape) cell
evaluated shape-only on the production meshes, with the roofline's inputs
counted per device (reference ``src/repro/launch/dryrun.py``). No weight is
ever materialised.

The reference lowers and compiles each cell with XLA and reads the
compiled program. The port has no compiler to ask: it runs the cell's step
once, eagerly, on ``meta`` tensors, as rank 0 of the production mesh (a
torch ``DeviceMesh`` over a fake process group, ``launch/mesh.py``):

* parameters are ``abstract_params`` (``models/common.py``) distributed as
  ``DTensor``s by ``distributed/sharding.py``'s rules, inputs are
  ``configs/shapes.py::input_specs`` sharded over the batch (and the decode
  cache by ``cache_shardings``), the optimizer state
  ``runtime/trainer.py::abstract_opt_state`` sharded by
  ``opt_state_shardings``;
* ``train`` counts one forward, backward and optimizer step
  (``make_train_step``), ``prefill`` the model's ``prefill`` to the exit,
  ``decode`` one ``decode_step``;
* ``launch/graph_analysis.py::CostCounter`` bills the local ops and the
  collectives of the step partitioned as XLA partitions it (a train
  step's gradients reduced onto their parameters' shardings); a plain
  tensor the model makes on the way (positions, rotations, masks) counts
  as replicated (``implicit_replication``).

A record has the reference's keys: ``cost_analysis`` ({flops, bytes
accessed}) and ``hlo_metrics`` ({flops, bytes}) are the counter's (one
eager run is trip-count-aware by construction), ``collectives`` its
collective bytes, ``memory_analysis`` the static argument bytes and the
peak of the live temporaries, ``lower_s`` the time to build and shard the
cell, ``compile_s`` the counted run's, ``hlo_bytes`` the number of ops
billed. A cell that fails (an op without a ``DTensor`` sharding rule, say)
writes an ``"error"`` record, as the reference's does; no op is counted
as run replicated in its place.

The output goes to ``artifacts/dryrun_torch`` (never ``artifacts/dryrun``,
which is the reference's and which ``tests/test_artifacts.py`` reads).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    applicable,
    get_config,
    input_specs,
    skip_reason,
)
from repro_torch.distributed.sharding import (
    batch_shardings,
    bytes_per_device,
    cache_shardings,
    param_shardings,
    serve_rules,
    serve_rules_ep_wide,
    train_rules,
    train_rules_pure_dp,
    tree_map,
)
from repro_torch.launch.graph_analysis import CostCounter
from repro_torch.launch.mesh import make_production_mesh, release_mesh
from repro_torch.models import build_model
from repro_torch.models.common import param_axes, set_params
from repro_torch.runtime.trainer import (
    abstract_opt_state,
    make_train_step,
    opt_state_shardings,
    pick_optimizer_for,
)

DEFAULT_OUT = "artifacts/dryrun_torch"


def _active_params(cfg, shapes) -> float:
    """Active (per-token) parameter count: total minus the non-routed share
    of expert stacks. ``shapes``: tensors by state-dict path."""
    total = sum(s.numel() for s in shapes.values())
    if cfg.num_experts and cfg.top_k:
        routed = sum(s.numel() for path, s in shapes.items()
                     if any("we_" in key for key in path.split(".")))
        total -= routed * (1.0 - cfg.top_k / cfg.num_experts)
    return float(total)


def _model_flops(cfg, shapes, kind: str, shape_spec) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    n_active = _active_params(cfg, shapes)
    if kind == "train":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 2.0 * n_active * tokens
    tokens = shape_spec.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def _shard(tree, shardings):
    flat = {}
    tree_map(lambda p, sh: flat.__setitem__(p, sh), shardings)
    return tree_map(lambda p, t: flat[p].shard_meta(t), tree)


def lower_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               serve_variant: str = "baseline", train_fsdp: bool = True,
               exit_idx: Optional[int] = None,
               overrides: Optional[dict] = None, ledger: bool = False):
    """Evaluate one (arch x shape) cell on ``mesh``; returns the record.

    ``overrides`` hot-patches LMConfig fields (e.g. {"rwkv_chunk": 32},
    {"mla_absorbed_decode": True}, {"vocab_pad_multiple": 256}, or a
    cut depth {"num_layers": 2, "exits": (1, 2)}). With ``ledger`` the
    record adds ``"ledger"``: the counter's flops and collective bytes
    by phase, rule and op (``CostCounter(ledger=True)``), as lists.
    """
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if getattr(cfg, "remat", None) == "dots":
        # XLA's "dots" policy keeps every product's output, so the
        # reference's backward recomputes no product; the port's checkpoint
        # would recompute the whole block
        cfg = dataclasses.replace(cfg, remat="none")
    spec = SHAPES[shape_name]
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    shapes = {k: p.detach() for k, p in model.named_parameters()}
    axes = param_axes(model)
    kind, kw = input_specs(cfg, shape_name, exit_idx=exit_idx, model=model)
    if kind == "train":
        # the trainer's float32 masters
        shapes = {k: torch.empty(v.shape, dtype=torch.float32,
                                 device="meta") for k, v in shapes.items()}
        if serve_variant == "pure-dp":
            rules = train_rules_pure_dp(multi_pod=multi_pod)
        else:
            rules = train_rules(multi_pod=multi_pod, fsdp=train_fsdp)
    else:
        rules = (serve_rules_ep_wide(multi_pod) if serve_variant == "ep-wide"
                 else serve_rules(multi_pod=multi_pod))
    p_sh = param_shardings(shapes, axes, rules, mesh)
    values = _shard(shapes, p_sh)
    counter = CostCounter(grad_placements={
        tuple(v.shape): v.placements for v in values.values()}
        if kind == "train" else None, ledger=ledger, as_xla=True)
    if kind == "train":
        opt = pick_optimizer_for(cfg)
        opt_shapes = abstract_opt_state(opt, shapes)
        opt_sh = opt_state_shardings(opt, shapes, axes, rules, mesh)
        b_sh = batch_shardings(kw["batch"], rules, mesh)
        opt_state, batch = _shard(opt_shapes, opt_sh), _shard(kw["batch"],
                                                             b_sh)
        step_fn = make_train_step(model, opt)
        arg_trees = [(shapes, p_sh), (opt_shapes, opt_sh),
                     (kw["batch"], b_sh)]
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counter, implicit_replication():
            step_fn(values, opt_state, batch, 0)
    elif kind == "prefill":
        b_sh = batch_shardings(kw["batch"], rules, mesh)
        batch = _shard(kw["batch"], b_sh)
        set_params(model, values)
        arg_trees = [(shapes, p_sh), (kw["batch"], b_sh)]
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counter, implicit_replication(), torch.no_grad():
            model.prefill(batch, kw["exit_idx"])
    else:  # decode
        tok_sh = batch_shardings(kw["token"], rules, mesh)
        c_sh = cache_shardings(kw["cache"], rules, mesh)
        token, cache = _shard(kw["token"], tok_sh), _shard(kw["cache"], c_sh)
        set_params(model, values)
        arg_trees = [(shapes, p_sh), (kw["token"], tok_sh),
                     (kw["cache"], c_sh)]
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        with counter, implicit_replication(), torch.no_grad():
            model.decode_step(token, cache, kw["exit_idx"])
    t_run = time.perf_counter() - t0

    static_bytes = sum(bytes_per_device(tree, sh) for tree, sh in arg_trees)
    metrics = counter.metrics()
    extra = {} if not ledger else {"ledger": {
        "flops": [list(k) + [v] for k, v in counter.ledger.items()],
        "collectives": [list(k) + [v]
                        for k, v in counter.coll_ledger.items()]}}
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "mesh": list(mesh.shape),
        "mesh_axes": list(mesh.mesh_dim_names),
        "num_devices": int(mesh.size()),
        "rules": rules.name,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_run, 2),
        "cost_analysis": {"flops": metrics["flops"],
                          "bytes accessed": metrics["bytes"]},
        "hlo_metrics": metrics,
        "memory_analysis": {"argument_size_in_bytes": static_bytes,
                            "temp_size_in_bytes": float(counter.peak_bytes)},
        "collectives": counter.collectives(),
        "bytes_per_device_static": static_bytes,
        "model_flops": _model_flops(cfg, shapes, kind, spec),
        "hlo_bytes": counter.ops,
        "serve_variant": serve_variant,
        "overrides": overrides or {},
        **extra,
    }


def list_cells(archs, shapes):
    """(arch, shape) for every cell, with the skip reason where the cell is
    not part of the assignment."""
    cells = []
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            if applicable(cfg, s):
                cells.append((a, s))
            else:
                cells.append((a, s, skip_reason(cfg, s)))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--serve-variant", default="baseline",
                    choices=["baseline", "ep-wide", "pure-dp"])
    ap.add_argument("--no-fsdp", action="store_true",
                    help="train with pure DP instead of FSDP (perf ablation)")
    ap.add_argument("--exit", type=int, default=None,
                    help="exit index for serve shapes (default: final)")
    ap.add_argument("--rwkv-chunk", type=int, default=0,
                    help="chunked-parallel WKV chunk length")
    ap.add_argument("--mla-absorbed", action="store_true",
                    help="absorbed-matrix MLA decode")
    ap.add_argument("--pad-vocab", type=int, default=0,
                    help="pad vocab to a multiple for sharding")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (variant label)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    if args.rwkv_chunk:
        overrides["rwkv_chunk"] = args.rwkv_chunk
    if args.mla_absorbed:
        overrides["mla_absorbed_decode"] = True
    if args.pad_vocab:
        overrides["vocab_pad_multiple"] = args.pad_vocab

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = list_cells(archs, shapes)
    if args.list:
        for c in cells:
            print(c)
        return 0

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "multi" if multi_pod else "single"
        for cell in cells:
            a, s = cell[0], cell[1]
            tag = f"{mesh_name}/{a}__{s}"
            out_path = os.path.join(
                args.out, mesh_name,
                f"{a}__{s}"
                + ("" if args.serve_variant == "baseline"
                   else f"__{args.serve_variant}")
                + ("" if args.exit is None else f"__e{args.exit}")
                + (f"__{args.tag}" if args.tag else "")
                + ".json")
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            if len(cell) == 3:
                rec = {"arch": a, "shape": s, "skipped": cell[2],
                       "mesh": mesh_name}
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[skip] {tag}: {cell[2]}")
                continue
            try:
                rec = lower_cell(a, s, mesh, multi_pod,
                                 serve_variant=args.serve_variant,
                                 train_fsdp=not args.no_fsdp,
                                 exit_idx=args.exit,
                                 overrides=overrides)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                ca = rec["cost_analysis"]
                print(
                    f"[ok]   {tag}: run={rec['compile_s']:.1f}s "
                    f"flops={ca.get('flops', float('nan')):.3e} "
                    f"coll={rec['collectives']['bytes']['total']:.3e}B "
                    f"static={rec['bytes_per_device_static']/2**30:.2f}GiB/dev"
                )
            except Exception:
                n_fail += 1
                err = traceback.format_exc()
                with open(out_path, "w") as f:
                    json.dump({"arch": a, "shape": s, "mesh": mesh_name,
                               "error": err[-4000:]}, f, indent=1)
                print(f"[FAIL] {tag}:\n{err[-2000:]}")
        release_mesh()
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
