"""Feed-forward layers (reference ``src/repro/models/moe.py``). This slice
carries the dense MLP; the Mixture-of-Experts layer waits for the rest of
the model zoo."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import make_param, swiglu


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    gated: bool = True             # SwiGLU (llama family) vs GeLU


def init_mlp(generator: torch.Generator, cfg: MLPConfig,
             dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.nn.Parameter]:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_up": make_param((d, f), generator, dtype=dtype),
        "w_down": make_param((f, d), generator, dtype=dtype),
    }
    if cfg.gated:
        p["w_gate"] = make_param((d, f), generator, dtype=dtype)
    return p


def mlp(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    if cfg.gated:
        h = swiglu(x @ params["w_gate"], x @ params["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]
