"""Shared model-substrate primitives of the port (reference
``src/repro/models/common.py``): the parameter initialiser, norms,
activations, rotary position embeddings, the vocab-padding mask and the
training losses.

Parameters are drawn from an explicit ``torch.Generator`` on the
generator's own device (the CPU for the ResNets and the tests; the card for
the served LMs, whose 12.8 billion values would take tens of seconds to draw
on the host). A seed gives the same weights on the same device; the draw
differs from ``jax.random`` bit for bit (two different generators), the
distribution is the same.

``rms_norm`` and ``rms_norm_pair`` go through the RMSNorm kernel's wrappers:
the plain version on a CPU tensor, the CUDA kernel on a card tensor; when a
gradient is wanted, their backward is the RMSNorm backward kernel's.

Parameters are made with ``requires_grad=False``: serving needs no graph.
Training (``repro_torch.runtime.trainer``) keeps float32 master values of
its own, which require gradients, and runs a model on them cast to
``cfg.dtype`` (``cast_floats``), as the reference casts its float32 values
at the forward's entry.

A block's parameters are a nested dict in the reference; ``ParamTree``
keeps that nesting as a module, so the state dict's keys are the
reference's paths.

Every parameter carries the reference's logical axis names (``vocab``,
``embed``, ``heads``, ``mlp``, ``expert``, ``embed_out`` or None per
dimension) as its ``axes`` attribute; ``param_axes`` collects them by
state-dict path for ``repro_torch.distributed.sharding``. The port keeps
one module per layer where the reference stacks layers, so a path's axes
are the reference's without the leading ``"layers"``. On the ``meta``
device (``meta_generator``) the initialisers draw nothing and allocate
nothing: ``abstract_params`` builds a 671B-parameter model that way.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import checks
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_pair


Axes = Tuple[Optional[str], ...]

META = torch.device("meta")


class _MetaGenerator:
    """The generator of a shape-only build: it names the ``meta`` device,
    and the initialisers below draw nothing from it."""

    device = META


def meta_generator() -> _MetaGenerator:
    """A stand-in generator for a build on the ``meta`` device (torch has
    no generator there)."""
    return _MetaGenerator()


def truncated_normal(shape: Sequence[int], generator: torch.Generator,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``scale * N(0, 1)`` truncated to [-2, 2], float32 on the generator's
    device (shape only on ``meta``).

    ``scale=None`` is the reference's fan-in rule: ``1/sqrt(shape[0])``.
    """
    shape = tuple(int(s) for s in shape)
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0] if shape else 1, 1))
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if out.device.type == "meta":
        return out
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(scale)


def _frozen(value: torch.Tensor, shape: Tuple[int, ...],
            axes: Optional[Axes]) -> torch.nn.Parameter:
    axes = (None,) * len(shape) if axes is None else tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the {len(shape)} "
                         f"dimensions of {shape}")
    param = torch.nn.Parameter(value, requires_grad=False)
    param.axes = axes
    return param


def make_param(shape: Sequence[int], generator: torch.Generator,
               init: str = "normal", scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32,
               axes: Optional[Axes] = None) -> torch.nn.Parameter:
    """The reference's ``make_param`` as a frozen ``nn.Parameter`` on the
    generator's device: ``"normal"`` (truncated normal, fan-in
    ``shape[0]`` unless ``scale`` is given), ``"embedding"`` (fan-in
    ``shape[-1]``), ``"zeros"`` or ``"ones"``. Drawn in float32, then cast
    to ``dtype``, as the reference casts its float32 parameters at the
    forward's entry. ``axes`` (one logical name or None per dimension;
    all None when omitted) becomes the parameter's ``axes``."""
    shape = tuple(int(s) for s in shape)
    device = generator.device
    if init not in ("zeros", "ones", "normal", "embedding"):
        raise ValueError(f"unknown init {init!r}")
    if device.type == "meta":
        value = torch.empty(shape, dtype=dtype, device=device)
    elif init == "zeros":
        value = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        value = torch.ones(shape, dtype=dtype, device=device)
    else:
        if scale is None:
            fan_in = shape[-1] if init == "embedding" else (
                shape[0] if shape else 1)
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        value = truncated_normal(shape, generator, scale).to(dtype)
    return _frozen(value, shape, axes)


def make_stacked_param(shape: Sequence[int], generator: torch.Generator,
                       dtype: torch.dtype = torch.float32,
                       axes: Optional[Axes] = None) -> torch.nn.Parameter:
    """``make_param(shape, generator, dtype=dtype, axes=axes)`` for a stack
    of experts ``[E, ...]``, drawn one expert at a time: the float32 draw of
    one slice is the only temporary (a whole DeepSeek-V3 expert stack in
    float32 would be 15 GB). The scale is the reference's fan-in rule on
    the whole shape, ``1/sqrt(E)``. Nothing is drawn on ``meta``."""
    shape = tuple(int(s) for s in shape)
    scale = 1.0 / math.sqrt(max(shape[0], 1))
    value = torch.empty(shape, dtype=dtype, device=generator.device)
    if value.device.type != "meta":
        for e in range(shape[0]):
            value[e] = truncated_normal(shape[1:], generator, scale)
    return _frozen(value, shape, axes)


def param_axes(module: nn.Module) -> Dict[str, Axes]:
    """Each parameter's logical axes by state-dict path; raises where a
    parameter was made without them."""
    out = {}
    for name, p in module.named_parameters():
        axes = getattr(p, "axes", None)
        if axes is None:
            raise ValueError(f"parameter {name} carries no logical axes")
        out[name] = axes
    return out


def set_params(module: nn.Module, values: Mapping[str, torch.Tensor]) -> None:
    """Put ``values`` (by state-dict path; e.g. ``DTensor``s on a mesh) in
    place of ``module``'s parameters, as frozen parameters."""
    for path, v in values.items():
        owner, _, leaf = path.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[leaf] = (
            v if isinstance(v, torch.nn.Parameter)
            else torch.nn.Parameter(v, requires_grad=False))


def abstract_params(init_fn: Callable[[torch.device], nn.Module]
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Axes]]:
    """Shape-only init: ``init_fn(meta)`` builds the module on the ``meta``
    device (no draw, no allocation); returns (meta tensor per state-dict
    path, its logical axes), the port's ``jax.eval_shape`` of the
    reference's init."""
    module = init_fn(META)
    shapes = {name: p.detach() for name, p in module.named_parameters()}
    return shapes, param_axes(module)


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: a leaf is a parameter, a
    sub-dict a submodule; ``tree[key]`` and ``key in tree`` read either."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, value)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dimension in float32 accumulation, cast back to
    x's dtype; one RMSNorm kernel launch on the card. A shape-only run
    (``meta``) keeps x's shape: flattening a ``DTensor`` sharded on two
    dimensions into rows is a reshard that the kernel's rows do not need."""
    if x.device.type == "meta":   # shape-only: the rows stay unflattened
        return rmsnorm(x, weight, eps=eps)
    d = x.shape[-1]
    return rmsnorm(x.reshape(-1, d).contiguous(), weight, eps=eps).reshape(
        x.shape)


def rms_norm_pair(q: torch.Tensor, q_weight: torch.Tensor, k: torch.Tensor,
                  k_weight: torch.Tensor, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rms_norm(q, q_weight), rms_norm(k, k_weight))`` for two tensors of
    one last dimension; one RMSNorm kernel launch on the card."""
    if q.device.type == "meta":
        return rmsnorm_pair(q, q_weight, k, k_weight, eps=eps)
    d = q.shape[-1]
    nq, nk = rmsnorm_pair(q.reshape(-1, d).contiguous(), q_weight,
                          k.reshape(-1, d).contiguous(), k_weight, eps=eps)
    return nq.reshape(q.shape), nk.reshape(k.shape)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """``[head_dim/2]`` float32 inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_rotation(positions: torch.Tensor, head_dim: int,
                  theta: float = 10000.0) -> torch.Tensor:
    """cos + i sin of every (position, frequency): complex64
    ``[..., S, 1, head_dim/2]`` for ``positions [..., S]``."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    ang = positions[..., :, None, None].to(torch.float32) * inv
    return torch.polar(torch.ones_like(ang), ang)


@functools.lru_cache(maxsize=64)
def prefix_rotation(s: int, head_dim: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    """``rope_rotation`` of positions 0..s-1, made once per (s, head_dim,
    theta, device): every layer of every prefill shares it. It is made with
    inference mode off, so that a rotation first made while serving (under
    ``torch.inference_mode``) can later be saved for a training backward."""
    with torch.inference_mode(False):
        return rope_rotation(torch.arange(s, device=device), head_dim, theta)


def rotate(x: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2i], x[2i+1]) of ``x [..., S, H, D]`` by
    ``rotation`` (from ``rope_rotation``), in float32, back to x's dtype."""
    d = x.shape[-1]
    pairs = torch.view_as_complex(
        x.to(torch.float32).contiguous().reshape(*x.shape[:-1], d // 2, 2))
    return torch.view_as_real(pairs * rotation).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by ``positions [..., S]``
    (broadcastable).

    Pairs (x[2i], x[2i+1]) are rotated: the interleaved convention of the
    reference, not Hugging Face's rotate-half. Each pair is one complex
    number, so the rotation is one complex product in float32.
    """
    return rotate(x, rope_rotation(positions.to(x.device), x.shape[-1],
                                   theta))


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask sharding-padding vocab slots to -1e30 (no-op when unpadded)."""
    if logits.shape[-1] == vocab:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return logits.masked_fill(~keep, -1e30)


def cast_floats(values: Mapping[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Float leaves cast to the compute dtype, the rest as they are (mixed
    precision: the float32 master copy stays with the optimizer; the
    forward runs on the cast, and the gradient reaches the master through
    the cast in float32)."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in values.items()}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level CE. logits ``[..., V]`` in float32, labels int."""
    return checks.partitioned("cross_entropy", _cross_entropy,
                              logits.to(torch.float32), labels, mask)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())
    # subtract before dropping the gathered axis: the same values, and the
    # only order in which a vocab-sharded DTensor's gather reduces
    nll = (logz[..., None] - gold)[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def weighted_exit_loss(per_exit_nll: Sequence[torch.Tensor],
                       weights: Sequence[float]) -> torch.Tensor:
    """Early-exit training objective: weighted sum of per-exit CE losses,
    the weights normalised to sum to 1 in float32.

    The paper trains every exit head jointly; the standard weighting puts
    full weight on the final head and smaller weight on early heads.
    """
    w = torch.tensor(weights, dtype=torch.float32)
    w = (w / torch.sum(w)).tolist()
    return sum(wi * li for wi, li in zip(w, per_exit_nll))
