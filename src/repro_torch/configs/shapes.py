"""Assigned input shapes and per-(arch x shape) applicability (reference
``src/repro/configs/shapes.py``).

LM shapes are (seq_len, global_batch):
  train_4k     4,096 x 256    -> one train step
  prefill_32k  32,768 x 32    -> prefill (inference)
  decode_32k   32,768 x 128   -> one decode step: ONE new token against a
                                  KV cache of seq_len
  long_500k    524,288 x 1    -> decode step; sub-quadratic archs only
                                  (SSM / hybrid); full-attention archs skip
                                  it

Inputs come back as tensors on the ``meta`` device: shapes and dtypes, no
storage. The decode cache is the model's own ``init_cache`` run on a model
built on ``meta``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import build_model
from repro_torch.models.transformer import LMConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Families whose serve-time state is sub-quadratic in context length.
_SUBQUADRATIC = ("rwkv", "jamba")


def applicable(cfg: LMConfig, shape_name: str) -> bool:
    """Whether an (arch x shape) cell is part of the assignment."""
    if shape_name == "long_500k":
        return cfg.family in _SUBQUADRATIC
    return True


def skip_reason(cfg: LMConfig, shape_name: str) -> Optional[str]:
    if applicable(cfg, shape_name):
        return None
    return (
        f"{cfg.arch_id} is pure full-attention; long_500k requires "
        "sub-quadratic attention (run only for SSM/hybrid archs)"
    )


def _src_len(cfg: LMConfig, seq_len: int, kind: str) -> int:
    """Frontend-stub source length for enc-dec (audio frames, ~4x
    downsampled from the target length; fixed 1k context for decode)."""
    return 1024 if kind == "decode" else max(seq_len // 4, 8)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: LMConfig, shape_name: str,
                exit_idx: Optional[int] = None, model=None):
    """Meta-tensor stand-ins for every model input of this cell.

    Returns (kind, kwargs) where kwargs match the corresponding step:
      train   -> {"batch": {...}}
      prefill -> {"batch": {...}, "exit_idx": e}
      decode  -> {"token": ..., "cache": ..., "exit_idx": e}
    Nothing is allocated. ``model`` (a build of ``cfg`` on ``meta``) saves
    building one for the decode cache.
    """
    spec = SHAPES[shape_name]
    if not applicable(cfg, shape_name):
        raise ValueError(skip_reason(cfg, shape_name))
    e = cfg.num_exits - 1 if exit_idx is None else exit_idx
    b, s = spec.global_batch, spec.seq_len
    tok = _meta((b, s), torch.int32)
    f32 = cfg.dtype

    if spec.kind == "train":
        batch = {"tokens": tok, "labels": tok}
        if cfg.frontend == "vision":
            # VLM stub: patch embeddings replace the token embedding input.
            batch = {"embeds": _meta((b, s, cfg.d_model), f32),
                     "labels": tok}
        if cfg.family == "encdec":
            batch["src_embeds"] = _meta(
                (b, _src_len(cfg, s, "train"), cfg.d_model), f32)
        return "train", {"batch": batch}

    if spec.kind == "prefill":
        batch = {"tokens": tok}
        if cfg.frontend == "vision":
            batch = {"embeds": _meta((b, s, cfg.d_model), f32)}
        if cfg.family == "encdec":
            batch["src_embeds"] = _meta(
                (b, _src_len(cfg, s, "prefill"), cfg.d_model), f32)
        return "prefill", {"batch": batch, "exit_idx": e}

    # decode: one new token against a cache of seq_len
    if model is None:
        model = build_model(cfg, device=META)
    if cfg.family == "encdec":
        cache = model.init_cache(b, s, e, src_len=_src_len(cfg, s, "decode"))
    else:
        cache = model.init_cache(b, s, e)
    token = _meta((b, 1), torch.int32)
    return "decode", {"token": token, "cache": cache, "exit_idx": e}


__all__ = ["SHAPES", "ShapeSpec", "applicable", "input_specs",
           "skip_reason"]
