"""Plain PyTorch version of the stability-score kernel: the same float32
arithmetic as ``csrc/stability_score.cu``, written as tensor ops (the port's
scheduler semantics in ``repro_torch.core.urgency``). The CPU tests and the
on-card comparison both use it."""

from __future__ import annotations

import torch

from repro_torch.core.urgency import (
    DEFAULT_CLIP,
    TauLike,
    candidate_stability_scores as stability_scores_ref,
    lattice_stability_scores as lattice_stability_scores_ref,
)

__all__ = ["stability_scores_ref", "lattice_stability_scores_ref",
           "stability_scores_plain"]


def stability_scores_plain(w, mask, cand_latency, cand_batch, cand_queue=None,
                           *, tau: TauLike, clip: float = DEFAULT_CLIP
                           ) -> torch.Tensor:
    """``ops.stability_scores``'s signature and boundary casts (latency to
    float32), computed by the plain version."""
    lat = cand_latency.to(torch.float32)
    if cand_queue is None:
        return stability_scores_ref(w, mask, lat, cand_batch, tau, clip)
    return lattice_stability_scores_ref(
        w, mask, lat, cand_batch, cand_queue, tau, clip)
