"""Training step assembly (reference ``src/repro/runtime/trainer.py``): the
loss and its gradients, gradient accumulation, global-norm clipping and the
optimizer.

The trainer owns the values it trains: a flat dict ``{name: tensor}`` of
float32 masters, one per model parameter (``master_values``). A step casts
them to the model's ``cfg.dtype`` (``cast_floats``; the reference casts its
float32 values at the forward's entry), runs the model's ``train_loss`` on
the cast values in place of the model's own parameters
(``torch.func.functional_call``), and takes the gradients with respect to
the masters, which therefore arrive in float32 whatever the compute dtype.
The model's own (serving) parameters are never read or changed by a step.

``train_step(values, opt_state, batch, step_no)`` returns new values and a
new optimizer state; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.distributed.sharding import (
    NamedSharding,
    ShardingRules,
    spec_for_param,
    tree_map,
)
from repro_torch.models.common import cast_floats
from repro_torch.optim import Adafactor, AdamW, Optimizer, clip_by_global_norm

Values = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    grad_clip: float = 1.0
    grad_accum: int = 1            # microbatches per step (summed in float32)
    compress_grads: bool = False   # int8 + error feedback (never read, as
                                   # in the reference)


def master_values(model: nn.Module) -> Values:
    """Float32 copies of ``model``'s parameters by name, on their device:
    the masters a trainer owns (the model's parameters stay as they
    are)."""
    return {name: p.detach().to(torch.float32).clone()
            for name, p in model.named_parameters()}


class _LossAndGrads(nn.Module):
    """``model.train_loss`` and its gradients with respect to ``leaves``,
    both taken inside one ``functional_call``, so that a block under
    ``torch.utils.checkpoint`` recomputes on the same values in the
    backward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, leaves: List[torch.Tensor]):
        loss, metrics = self.model.train_loss(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)


def make_grad_fn(model: nn.Module) -> Callable:
    """``fn(values, batch) -> (loss, metrics, grads)``: ``model``'s
    ``train_loss`` on ``values`` (float32 masters by parameter name) cast
    to ``cfg.dtype``, and its float32 gradient with respect to each master
    (zeros where the loss does not reach one). Loss and metrics are
    detached."""
    runner = _LossAndGrads(model)
    dtype = getattr(model.cfg, "dtype", torch.float32)

    def loss_and_grads(values: Values, batch):
        names = list(values)
        leaves = [values[k].detach().requires_grad_(True) for k in names]
        cast = cast_floats(dict(zip(names, leaves)), dtype)
        with torch.enable_grad():
            loss, metrics, grads = functional_call(
                runner, {f"model.{k}": v for k, v in cast.items()},
                (batch, leaves))
        grads = {k: (torch.zeros_like(values[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        return loss, metrics, grads

    return loss_and_grads


def make_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    grad_clip: float = 1.0,
    grad_accum: int = 1,
) -> Callable:
    """Build ``train_step(values, opt_state, batch, step_no) -> (values,
    opt_state, metrics)`` for ``model`` (any model with ``train_loss(batch)
    -> (loss, metrics)``); metrics gain ``grad_norm`` (before clipping).

    With ``grad_accum > 1`` the batch is split along dim 0 into that many
    microbatches, run one after another; their float32 gradients are
    summed and divided by the count, and the loss is their mean (metrics
    then hold ``loss`` and ``grad_norm`` only, as the reference's). A
    parameter the loss does not reach gets a zero gradient.
    """
    loss_and_grads = make_grad_fn(model)

    def train_step(values: Values, opt_state, batch, step_no: int):
        if grad_accum <= 1:
            loss, metrics, grads = loss_and_grads(values, batch)
        else:
            grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device)
                     for k, v in values.items()}
            loss_sum = None
            for i in range(grad_accum):
                micro = {k: x.reshape(grad_accum, x.shape[0] // grad_accum,
                                      *x.shape[1:])[i]
                         for k, x in batch.items()}
                loss, _, g = loss_and_grads(values, micro)
                grads = {k: grads[k] + g[k] for k in grads}
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = {k: g / grad_accum for k, g in grads.items()}
            metrics = {"loss": loss_sum / grad_accum}
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        new_values, new_opt = optimizer.step(values, grads, opt_state,
                                             step_no)
        return new_values, new_opt, {**metrics, "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# Optimizer-state sharding
# ---------------------------------------------------------------------------

def _ref_order(path: str):
    """The order in which the reference's pytree flattening visits a leaf:
    dict keys sorted, list items by index."""
    return tuple(int(c) if c.isdigit() else c for c in path.split("."))


def stacked_layers(names) -> Dict[str, int]:
    """{name: the layers the reference stacks the parameter over}: a
    block's ``segments.{i}.{l}.{path}`` over segment i's blocks, the
    encoder's ``encoder.{l}.{path}`` over its blocks (the reference keeps
    each as one leaf ``[n, ...]``, ``models/convert.py``); 0 for a
    parameter the reference keeps as it is."""
    def stack(name):
        p = name.split(".")
        if (p[0] == "segments" and len(p) > 3 and p[1].isdigit()
                and p[2].isdigit()):
            return ".".join(p[:2]), p[2]
        if p[0] == "encoder" and len(p) > 2 and p[1].isdigit():
            return "encoder", p[1]
        return None, None

    layers: Dict[str, set] = {}
    for name in names:
        prefix, layer = stack(name)
        if prefix is not None:
            layers.setdefault(prefix, set()).add(layer)
    return {name: len(layers.get(stack(name)[0], ())) for name in names}


def opt_state_shardings(opt: Optimizer, param_shapes: Values,
                        axes_tree: Dict[str, tuple], rules: ShardingRules,
                        mesh):
    """A sharding for every leaf of ``opt``'s state (a tree of dicts like
    the state itself).

    AdamW moments mirror the params exactly; Adafactor's factored
    accumulators drop one dim: the matching logical axis is dropped from
    the spec by shape alignment. As in the reference, the first parameter
    of a shape (in the reference's flattening order) lends that shape its
    axes, the shape being the one the reference's tree gives it: a block's
    parameter stacked over its segment's layers (:func:`stacked_layers`),
    so that a block's ``[D]`` vector and an exit's ``[D]`` norm do not
    share their axes.
    """
    state_shapes = abstract_opt_state(opt, param_shapes)
    stacked = stacked_layers(param_shapes)

    def ref_shape(name, shape):
        n = stacked.get(name, 0)
        return ((n,) if n else ()) + tuple(shape)

    shape_to_axes = {}
    for name in sorted(param_shapes, key=_ref_order):
        shape_to_axes.setdefault(
            ref_shape(name, param_shapes[name].shape),
            ((None,) if stacked.get(name) else ()) + tuple(axes_tree[name]))

    def param_of(path):
        parts = path.split(".")
        for name in (".".join(parts[1:]), ".".join(parts[1:-1])):
            if name in param_shapes:
                return name
        return None

    def spec_by_shape(path, s):
        name = param_of(path)
        n = stacked.get(name, 0)
        shape = ref_shape(name, s.shape)
        spec = None
        if shape in shape_to_axes:
            spec = spec_for_param(shape, shape_to_axes[shape], rules, mesh)
        else:
            # factored accumulator: find a param shape it was reduced from
            for pshape, axes in shape_to_axes.items():
                if len(pshape) != len(shape) + 1:
                    continue
                for drop in range(len(pshape)):
                    if tuple(d for i, d in enumerate(pshape)
                             if i != drop) == shape:
                        spec = spec_for_param(
                            shape, tuple(a for i, a in enumerate(axes)
                                         if i != drop), rules, mesh)
                        break
                if spec is not None:
                    break
        if spec is None:
            return NamedSharding(mesh, ())  # scalar counters etc.
        return NamedSharding(mesh, tuple(spec)[1:] if n else spec)

    return tree_map(spec_by_shape, state_shapes)


def abstract_opt_state(opt: Optimizer, param_shapes: Values):
    """``opt.init`` on ``meta`` stand-ins of ``param_shapes`` (tensors or
    meta tensors by name): the state's shapes and dtypes, nothing
    allocated."""
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in param_shapes.items()}
    return opt.init(meta)


def pick_optimizer_for(cfg, lr=3e-4) -> Optimizer:
    """Adafactor for >=50B params (factored state is what fits in device
    memory); AdamW otherwise."""
    big = cfg.arch_id in ("deepseek-v3-671b", "jamba-v0.1-52b")
    return Adafactor(lr=lr) if big else AdamW(lr=lr)


__all__ = ["TrainConfig", "abstract_opt_state", "make_grad_fn",
           "make_train_step",
           "master_values", "opt_state_shardings", "pick_optimizer_for",
           "stacked_layers"]
