"""Synthetic data streams of the port (reference ``src/repro/data``)."""

from repro_torch.data.pipeline import (
    cifar100_like,
    synthetic_lm_batches,
    synthetic_memorization_corpus,
)

__all__ = [
    "cifar100_like",
    "synthetic_lm_batches",
    "synthetic_memorization_corpus",
]
