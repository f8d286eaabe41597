"""Shared helpers of the port's distribution tests: the reference's trees
flattened to the port's state-dict paths, and the reference's dry-run
module imported without leaking its device-count flag."""

from __future__ import annotations

import importlib
import os

import jax
import numpy as np


def ref_dryrun():
    """``repro.launch.dryrun``: its first statement sets ``XLA_FLAGS`` for
    512 host devices. The backend is initialised before the import (so the
    flag cannot reach this process's JAX) and the environment restored
    after it (so it cannot reach a later subprocess)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)) and not (
            tree and all(isinstance(a, (str, type(None))) for a in tree)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _axes_leaves(tree, prefix=""):
    """Like ``_leaves`` for an axes tree, whose leaves are tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _axes_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _axes_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tuple(tree)


def ref_per_layer(shapes, axes):
    """The reference's (shapes, axes) trees -> {port path: (shape, dtype
    name, axes)}: a segment's (or the encoder's) stacked leaf ``path [n,
    ...]`` with axes ``("layers", ...)`` becomes ``segments.{i}.{l}.{path}``
    for l < n, without the layers axis, as the port keeps one module per
    layer."""
    flat_s = dict(_leaves(shapes))
    flat_a = dict(_axes_leaves(axes))
    assert set(flat_s) == set(flat_a)
    out = {}
    for path, s in flat_s.items():
        a = flat_a[path]
        parts = path.split(".")
        stacked = parts[0] == "encoder" or parts[0] == "segments"
        if not stacked:
            out[path] = (tuple(s.shape), np.dtype(s.dtype).name, a)
            continue
        assert a[0] == "layers", (path, a)
        head = 2 if parts[0] == "segments" else 1
        for layer in range(s.shape[0]):
            p = ".".join(parts[:head] + [str(layer)] + parts[head:])
            out[p] = (tuple(s.shape[1:]), np.dtype(s.dtype).name, a[1:])
    return out


def ref_leaves(tree):
    """{path: (shape, dtype name)} of a reference tree of arrays or
    ShapeDtypeStructs (dict keys sorted, list items by index)."""
    return {p: (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in _leaves(tree)}


def torch_dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def psum_worker(rank: int, world: int, store_path: str, inputs, out_path):
    """One rank of a gloo job: ``compressed_psum`` of ``inputs[rank]``,
    saved to ``out_path.{rank}``."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.runtime.fault_tolerance import ElasticMesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        got = compressed_psum(torch.from_numpy(inputs[rank]))
        mesh, accum = ElasticMesh(model_axis=1).build(device="cpu")
        torch.save({"psum": got, "mesh": tuple(mesh.shape), "accum": accum},
                   f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()
