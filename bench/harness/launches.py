"""Kernel launches that the engine's decisions imply, copied from the
port's smoke script (``implied_launches``) for the families the benchmark
serves.

One served quantum at exit e of L = exits[e] decoder layers launches:

* dense GQA decoder: rmsnorm 2 L (3 L with q/k norm: q and k in one
  launch), flash attention L, the exit head once;
* encoder-decoder: rmsnorm 3 L + 2 L_enc + 1 (the encoder's norms and its
  final norm), flash attention L + L_enc (prefill cross-attention is plain
  torch), the exit head once.

Each scoring round with a non-empty snapshot launches the stability score
once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import families

KERNELS = ("rmsnorm", "flash_attention", "exit_head", "stability_score")


def quantum_launches(lm: dict, exit_idx: int) -> Dict[str, int]:
    layers = lm["exits"][exit_idx]
    if lm["family"] == "encdec":
        norms = 3 * layers + 2 * lm["num_encoder_layers"] + 1
        attn = layers + lm["num_encoder_layers"]
    elif lm["family"] == "dense":
        norms = (3 if lm.get("qk_norm") else 2) * layers
        attn = layers
    else:
        return families.module(lm["family"]).quantum_launches(lm, exit_idx)
    return {"rmsnorm": norms, "flash_attention": attn, "exit_head": 1}


def implied(lms: Sequence[dict], decisions: Iterable[Tuple[int, int]],
            scoring_rounds: int) -> Dict[str, int]:
    """Launches per kernel for quanta ``(model, exit)`` and the scoring
    rounds."""
    want = {k: 0 for k in KERNELS}
    for m, e in decisions:
        for k, n in quantum_launches(lms[m], e).items():
            want[k] += n
    want["stability_score"] = scoring_rounds
    return want
