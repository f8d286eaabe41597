"""Optimizers of the port over flat dicts of tensors (reference
``src/repro/optim``)."""

from repro_torch.optim.optimizers import (
    SGD,
    AdamW,
    Adafactor,
    OptState,
    Optimizer,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)

__all__ = [
    "AdamW",
    "Adafactor",
    "OptState",
    "Optimizer",
    "SGD",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "make_optimizer",
]
