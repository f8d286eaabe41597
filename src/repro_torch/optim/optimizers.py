"""Optimizers of the port (reference ``src/repro/optim/optimizers.py``):
AdamW, Adafactor (factored second moments), SGD; global-norm clipping; the
cosine learning-rate schedule.

Each optimizer is functional over a flat dict ``{name: tensor}`` of master
values: ``init(values) -> state`` and ``step(values, grads, state,
step_no) -> (values, state)``, with a state that mirrors the values dict
(``{"m": {...}, "v": {...}}`` for AdamW). Nothing is updated in place. The
arithmetic is the reference's, in the reference's order: AdamW adds the
weight decay to the bias-corrected update before scaling by the learning
rate (``torch.optim.AdamW`` decays the weights apart, so it is not used);
Adafactor factors over the two largest dims at >= 128 and clips the update
by its RMS. The step's scalars (the learning rate, the bias corrections,
Adafactor's beta) are the reference's float32 values, computed on the host
in numpy float32 and handed to the tensor ops as Python floats, which carry
a float32 value exactly: no device round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Values = Mapping[str, torch.Tensor]
OptState = Any

_F32 = np.float32


def global_norm(tree: Values) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device); leaves are summed in sorted-name order, as
    ``jax.tree.leaves`` orders a dict."""
    leaves = [tree[k] for k in sorted(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_by_global_norm(tree: Values, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every leaf scaled by ``min(1, max_norm / max(norm, 1e-9))`` in
    float32 and cast back to its dtype; returns (the clipped dict, the
    norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (x.to(torch.float32) * scale).to(x.dtype)
            for k, x in tree.items()}, norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], np.float32]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; the reference's float32
    arithmetic on the host."""
    lr0, lo = _F32(base_lr), _F32(min_frac)
    span = _F32((1 - min_frac) * 0.5)

    def lr(step) -> np.float32:
        step = _F32(step)
        warm = lr0 * np.minimum(step / _F32(max(warmup, 1)), _F32(1.0))
        t = np.clip((step - _F32(warmup)) / _F32(max(total - warmup, 1)),
                    _F32(0.0), _F32(1.0))
        cos = lr0 * (lo + span * (_F32(1.0) + np.cos(_F32(np.pi) * t)))
        return _F32(warm if step < warmup else cos)

    return lr


class Optimizer:
    """init(values) -> state; step(values, grads, state, step_no) ->
    (new_values, new_state)."""

    def _lr(self, step_no) -> float:
        """The learning rate at ``step_no`` as a float32 value."""
        return float(_F32(self.lr(step_no) if callable(self.lr)
                          else self.lr))

    def init(self, values: Values) -> OptState:
        raise NotImplementedError

    def step(self, values: Values, grads: Values, state: OptState,
             step_no: int):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGD(Optimizer):
    lr: Any = 1e-2
    momentum: float = 0.9

    def init(self, values):
        return {"mu": {k: torch.zeros_like(p) for k, p in values.items()}}

    def step(self, values, grads, state, step_no):
        lr = self._lr(step_no)
        mu = {k: self.momentum * m + grads[k].to(m.dtype)
              for k, m in state["mu"].items()}
        new = {k: (p - lr * mu[k]).to(p.dtype) for k, p in values.items()}
        return new, {"mu": mu}


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    lr: Any = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, values):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {k: zeros(p) for k, p in values.items()},
                "v": {k: zeros(p) for k, p in values.items()}}

    def step(self, values, grads, state, step_no):
        lr = self._lr(step_no)
        t = _F32(step_no) + _F32(1.0)
        bc1 = float(_F32(1.0) - _F32(self.b1) ** t)
        bc2 = float(_F32(1.0) - _F32(self.b2) ** t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in values.items():
            g = grads[k].to(torch.float32)
            m = self.b1 * state["m"][k] + (1 - self.b1) * g
            v = self.b2 * state["v"][k] + (1 - self.b2) * g * g
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            update = update + self.weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32) - lr * update).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}


@dataclasses.dataclass(frozen=True)
class Adafactor(Optimizer):
    """Factored second-moment optimizer (Shazeer & Stern, 2018). For an
    [r, c] matrix it keeps row/col accumulators instead of the full [r, c]
    moment; >=3D values are factored over their two largest dims; 1D
    values keep full moments."""

    lr: Any = 1e-2
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    min_dim_size_to_factor: int = 128

    def _factored_dims(self, shape) -> Optional[Tuple[int, int]]:
        if len(shape) < 2:
            return None
        sorted_dims = sorted(range(len(shape)), key=lambda i: shape[i])
        r, c = sorted_dims[-2], sorted_dims[-1]
        if shape[r] < self.min_dim_size_to_factor:
            return None
        return (r, c)

    def init(self, values):
        def one(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)
            f = self._factored_dims(p.shape)
            if f is None:
                return {"v": zeros(p.shape)}
            r, c = f
            return {"vr": zeros([d for i, d in enumerate(p.shape) if i != c]),
                    "vc": zeros([d for i, d in enumerate(p.shape) if i != r])}
        return {"v": {k: one(p) for k, p in values.items()}}

    def step(self, values, grads, state, step_no):
        lr = self._lr(step_no)
        t = _F32(step_no) + _F32(1.0)
        beta = float(_F32(1.0) - t ** _F32(-self.decay))
        one_minus_beta = float(_F32(1.0) - _F32(beta))
        new_p, new_v = {}, {}
        for k, p in values.items():
            g = grads[k].to(torch.float32)
            s = state["v"][k]
            g2 = g * g + self.eps
            f = self._factored_dims(p.shape)
            if f is None:
                v = beta * s["v"] + one_minus_beta * g2
                update = g * torch.rsqrt(v + self.eps)
                new_s = {"v": v}
            else:
                r, c = f
                vr = beta * s["vr"] + one_minus_beta * torch.mean(g2, dim=c)
                vc = beta * s["vc"] + one_minus_beta * torch.mean(g2, dim=r)
                r_factor = torch.rsqrt(
                    vr / torch.mean(vr, dim=-1, keepdim=True) + self.eps)
                c_factor = torch.rsqrt(vc + self.eps)
                update = g * r_factor.unsqueeze(c) * c_factor.unsqueeze(r)
                new_s = {"vr": vr, "vc": vc}
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(update * update))
            update = update / torch.clamp(rms / self.clip_threshold, min=1.0)
            new_p[k] = (p.to(torch.float32) - lr * update).to(p.dtype)
            new_v[k] = new_s
        return new_p, {"v": new_v}


def make_optimizer(name: str, lr: Any = None, **kw) -> Optimizer:
    name = name.lower()
    if name == "adamw":
        return AdamW(lr=lr if lr is not None else 3e-4, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr if lr is not None else 1e-2, **kw)
    if name == "sgd":
        return SGD(lr=lr if lr is not None else 1e-2, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
