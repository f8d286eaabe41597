"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP / SP + pod)
(reference ``src/repro/distributed/sharding.py``).

Every parameter carries logical axis names (its ``axes``; see
``repro_torch.models.common.param_axes``); these rules map them to mesh
axes. A spec is the reference's per-dimension form, a tuple with one entry
per tensor dimension: None (replicated), a mesh axis name, or a tuple of
names (the dimension split over several mesh axes, major to minor).
``placements`` turns a spec into the ``DTensor`` placements of a torch
``DeviceMesh``: one placement per mesh dimension, ``Shard(d)`` where the
spec puts that mesh axis on tensor dimension d, else ``Replicate()``; a
dimension split over two mesh axes is sharded by both, in mesh order, which
gives the local shape of the reference's ``NamedSharding``.

Divisibility is sanitised: a mesh axis that does not evenly divide the
corresponding dimension is dropped from the spec (replicating that
dimension) instead of failing, e.g. seamless' 256,206-row vocab is not
16-divisible, starcoder2's 36 heads reshape unevenly.

Rule presets:
  * train_rules: Megatron-style TP over "model" (heads/mlp/expert/vocab) +
    FSDP over ("pod","data") for the remaining large dims ("embed"),
    ZeRO-3-equivalent: optimizer states inherit param specs.
  * serve_rules: TP only; params replicated across "data"/"pod" (each data
    shard serves its own requests); KV caches sharded batch->data,
    sequence->model (flash-decode style sequence parallelism).
  * serve_rules_ep_wide: experts sharded over ("data","model") (e.g.
    256-way EP for deepseek-v3), tokens replicated across "data" during
    expert compute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axes."""

    rules: "dict[str, AxisVal]"
    # Activation conventions (used by batch/cache spec builders).
    batch_axes: AxisVal = ("data",)
    seq_axes: AxisVal = None       # sequence-parallel axis for caches
    name: str = "custom"

    def axis_for(self, logical: Optional[str]) -> AxisVal:
        if logical is None:
            return None
        return self.rules.get(logical)


def train_rules(multi_pod: bool = False, fsdp: bool = True) -> ShardingRules:
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(
        rules={
            "vocab": "model",
            "embed": dp if fsdp else None,
            "heads": "model",
            "mlp": "model",
            "expert": "model",
            "embed_out": None,
            "layers": None,
        },
        batch_axes=dp,
        seq_axes=None,
        name=("train-fsdp" if fsdp else "train-dp")
        + ("-multipod" if multi_pod else ""),
    )


def train_rules_pure_dp(multi_pod: bool = False) -> ShardingRules:
    """Classic data parallelism for small models whose head counts defeat
    16-way TP (e.g. smollm's 9 heads): params fully replicated, the batch
    sharded over BOTH mesh axes (256/512-way DP)."""
    dp: Tuple[str, ...] = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
    return ShardingRules(
        rules={
            "vocab": None,
            "embed": None,
            "heads": None,
            "mlp": None,
            "expert": None,
            "embed_out": None,
            "layers": None,
        },
        batch_axes=dp,
        seq_axes=None,
        name="train-pure-dp" + ("-multipod" if multi_pod else ""),
    )


def serve_rules(multi_pod: bool = False) -> ShardingRules:
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(
        rules={
            "vocab": "model",
            "embed": None,          # replicated: every data shard serves alone
            "heads": "model",
            "mlp": "model",
            "expert": "model",
            "embed_out": None,
            "layers": None,
        },
        batch_axes=dp,
        seq_axes="model",           # KV cache sequence-sharding (flash-decode)
        name="serve" + ("-multipod" if multi_pod else ""),
    )


def serve_rules_ep_wide(multi_pod: bool = False) -> ShardingRules:
    """Serving layout for huge MoE: experts sharded over the full device
    count (EP = data x model) and non-expert params FSDP-sharded over
    "data"."""
    base = serve_rules(multi_pod)
    return dataclasses.replace(
        base,
        rules={**base.rules, "expert": ("data", "model"), "embed": "data"},
        name="serve-ep-wide" + ("-multipod" if multi_pod else ""),
    )


# ---------------------------------------------------------------------------
# Spec construction + sanitisation
# ---------------------------------------------------------------------------

def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a torch ``DeviceMesh`` (or of anything with a
    mapping ``shape``, as the reference's meshes have)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _names(ax: AxisVal) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def sanitize_spec(shape: Sequence[int], spec: Sequence[AxisVal],
                  mesh) -> Spec:
    """Drop mesh axes that don't divide the dim (replicate instead),
    and drop axes that appear more than once across dims."""
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    out = []
    spec = tuple(spec)
    for dim, ax in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        keep = []
        size = 1
        for a in _names(ax):
            if a in used:
                continue
            s = sizes[a]
            if dim % (size * s) == 0:
                keep.append(a)
                size *= s
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return tuple(out)


def spec_for_param(shape: Sequence[int], axes: Tuple[Optional[str], ...],
                   rules: ShardingRules, mesh) -> Spec:
    spec = tuple(rules.axis_for(a) for a in axes)
    return sanitize_spec(shape, spec, mesh)


def placements(spec: Sequence[AxisVal], mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: per mesh
    dimension, ``Shard(d)`` where the spec names that axis on tensor
    dimension d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, ax in enumerate(spec):
        for a in _names(ax):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def shard_count(spec: Sequence[AxisVal], mesh) -> int:
    """How many ways ``spec`` splits a tensor (the product of the sizes of
    the mesh axes it names)."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for ax in spec for a in _names(ax))


def local_shape(shape: Sequence[int], spec: Sequence[AxisVal],
                mesh) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` under a sanitised
    ``spec`` (every named axis divides its dimension)."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(
        n // math.prod(sizes[a] for a in _names(ax))
        for n, ax in zip(shape, tuple(spec) + (None,) * len(shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)

    def shard_meta(self, t: torch.Tensor):
        """A ``DTensor`` of ``t``'s global shape and dtype whose local
        tensor is this rank's shard on the ``meta`` device (nothing is
        allocated or moved)."""
        from torch.distributed.tensor import DTensor

        local = torch.empty(self.local_shape(t.shape), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def tree_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists whose leaves are
    tensors; paths are the state-dict form (``segments.0.k``)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, f"{path}{i}.") for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def tree_leaves(tree):
    """``(path, leaf)`` pairs of a tree of dicts and lists, in order."""
    out = []
    tree_map(lambda p, x: out.append((p, x)), tree)
    return out


def param_shardings(shapes: Mapping[str, torch.Tensor],
                    axes: Mapping[str, Tuple[Optional[str], ...]],
                    rules: ShardingRules, mesh) -> Dict[str, NamedSharding]:
    """One sharding per parameter path (``shapes``: tensors or meta tensors
    by state-dict path, ``axes`` their logical axes)."""
    return {k: NamedSharding(mesh, spec_for_param(s.shape, axes[k], rules,
                                                  mesh))
            for k, s in shapes.items()}


# -- activation / input specs -------------------------------------------------

def batch_shardings(batch_tree, rules: ShardingRules, mesh):
    """Shard every batch input along its leading (batch) dim."""

    def one(_path, s):
        spec = (rules.batch_axes,) + (None,) * (len(s.shape) - 1)
        return NamedSharding(mesh, sanitize_spec(s.shape, spec, mesh))

    return tree_map(one, batch_tree)


def _cache_leaf_spec(path_str: str, shape, rules: ShardingRules) -> Spec:
    """Spec for one KV-cache / state leaf by naming convention.

    Stacked cache layouts (leading ``layers`` axis):
      k/v:    [L, B, S, K, Dh]   -> (None, batch, seq, None, None)
      c_kv:   [L, B, S, dc]      -> (None, batch, seq, None)   (MLA latent)
      k_pe:   [L, B, S, r]       -> (None, batch, seq, None)
      len:    [L, B]             -> (None, batch)
      wkv:    [L, B, H, N, N]    -> (None, batch, model, None, None)
      shift:  [L, B, D]          -> (None, batch, None)
      h:      [L, B, Di, N]      -> (None, batch, model, None)  (mamba)
      conv:   [L, B, K-1, Di]    -> (None, batch, None, None)
    """
    nd = len(shape)
    b = rules.batch_axes
    s = rules.seq_axes
    leaf = path_str.rsplit(".", 1)[-1]
    if leaf in ("k", "v") and nd == 5:
        return (None, b, s, None, None)
    if leaf in ("c_kv", "k_pe") and nd == 4:
        return (None, b, s, None)
    if leaf == "len":
        return (None,) * (nd - 1) + (b,) if nd == 1 else (None, b)
    if leaf == "wkv" and nd == 5:
        return (None, b, "model", None, None)
    if leaf == "h" and nd == 4:
        return (None, b, "model", None)
    if leaf in ("shift", "conv"):
        return (None, b) + (None,) * (nd - 2)
    # fallback: batch on dim 1 (after layers)
    return (None, b) + (None,) * (nd - 2) if nd >= 2 else (None,)


def cache_shardings(cache_tree, rules: ShardingRules, mesh):
    def one(path, s):
        spec = _cache_leaf_spec(path, s.shape, rules)
        return NamedSharding(mesh, sanitize_spec(s.shape, spec, mesh))

    return tree_map(one, cache_tree)


def replicated(tree, mesh):
    return tree_map(lambda _p, _x: NamedSharding(mesh, ()), tree)


def bytes_per_device(tree, shardings) -> float:
    """Static per-device bytes of a sharded tree of (meta) tensors."""
    total = 0.0
    flat_s = dict(tree_leaves(shardings))
    for path, leaf in tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        sh = flat_s[path]
        total += (leaf.numel() * leaf.element_size()
                  / shard_count(sh.spec, sh.mesh))
    return total


__all__ = ["AxisVal", "NamedSharding", "ShardingRules", "Spec",
           "batch_shardings", "bytes_per_device", "cache_shardings",
           "local_shape", "mesh_axis_sizes", "param_shardings",
           "placements", "replicated", "sanitize_spec", "serve_rules",
           "serve_rules_ep_wide", "shard_count", "spec_for_param",
           "train_rules", "train_rules_pure_dp", "tree_leaves", "tree_map"]
