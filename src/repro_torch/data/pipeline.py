"""Data pipeline of the port (reference ``src/repro/data/pipeline.py``):
deterministic synthetic streams, no downloads, shaped like the real
workloads.

* ``synthetic_lm_batches`` — Zipf-distributed token stream with a Markov
  backbone so a ~100M model has structure to learn; enc-dec and VLM
  variants emit the frontend-stub embeddings.
* ``cifar100_like`` — CIFAR-100-shaped image batches with class-conditional
  structure (the paper's request payloads).
* ``synthetic_memorization_corpus`` — small fixed corpus for convergence
  tests.

The draws are the reference's, from numpy ``Generator``s in the same order,
so a seed gives the reference's batches exactly; the batches are tensors on
the requested device (the card unless the caller passes ``"cpu"``): int32
tokens and labels, float32 embeddings and images.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _zipf_markov_tokens(rng: np.random.Generator, batch: int, seq: int,
                        vocab: int) -> np.ndarray:
    """Tokens with local structure: next ~ 0.7 * f(prev) + 0.3 * Zipf."""
    ranks = np.arange(1, vocab + 1)
    zipf = 1.0 / ranks
    zipf /= zipf.sum()
    # deterministic "grammar": successor table
    succ = rng.permutation(vocab)
    toks = np.empty((batch, seq), dtype=np.int64)
    toks[:, 0] = rng.choice(vocab, size=batch, p=zipf)
    follow = rng.uniform(size=(batch, seq)) < 0.7
    draws = rng.choice(vocab, size=(batch, seq), p=zipf)
    for t in range(1, seq):
        toks[:, t] = np.where(follow[:, t], succ[toks[:, t - 1]],
                              draws[:, t])
    return toks


def _tensor(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def synthetic_lm_batches(
    vocab: int,
    batch: int,
    seq: int,
    seed: int = 0,
    encdec: bool = False,
    vision: bool = False,
    d_model: int = 64,
    src_len: int = 16,
    device: DeviceLike = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless iterator of training batches for any LM family."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        toks = _zipf_markov_tokens(rng, batch, seq + 1, vocab)
        b = {
            "tokens": _tensor(toks[:, :-1], np.int32, device),
            "labels": _tensor(toks[:, 1:], np.int32, device),
        }
        if encdec:
            b["src_embeds"] = _tensor(
                rng.normal(size=(batch, src_len, d_model)), np.float32,
                device)
        if vision:
            emb = rng.normal(size=(batch, seq, d_model))
            b = {"embeds": _tensor(emb, np.float32, device),
                 "labels": b["labels"]}
        yield b


def cifar100_like(
    batch: int,
    num_classes: int = 100,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One CIFAR-100-shaped batch (NHWC float32 images, int32 labels) with
    class-conditional colour/frequency structure (learnable but synthetic;
    no dataset is downloaded)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=batch)
    base_colour = np.stack([
        np.sin(labels * 0.7), np.cos(labels * 1.3), np.sin(labels * 2.1)
    ], axis=-1)[:, None, None, :]
    imgs = base_colour + 0.25 * rng.normal(size=(batch, 32, 32, 3))
    return (_tensor(imgs, np.float32, device),
            _tensor(labels, np.int32, device))


def synthetic_memorization_corpus(vocab: int, n: int = 8, seq: int = 32,
                                  seed: int = 3,
                                  device: DeviceLike = None
                                  ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(n, seq))
    return {"tokens": _tensor(toks, np.int32, device),
            "labels": _tensor(toks, np.int32, device)}
