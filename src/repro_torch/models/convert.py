"""Parameter conversion from the reference's trees to the port's modules.

The reference keeps parameters as nested dicts and lists of arrays; the
port keeps them in ``nn.Module`` state dicts. The converters take the
reference's tree with numpy leaves, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.resnet import ResNetConfig
from repro_torch.models.transformer import LMConfig


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def resnet_params_from_jax(values_np: Dict[str, Any],
                           cfg: ResNetConfig) -> Dict[str, torch.Tensor]:
    """The reference ResNet's value tree (numpy leaves) -> the state dict of
    :class:`repro_torch.models.resnet.EarlyExitResNet`.

    Conv weights go from HWIO to OIHW; GroupNorm ``scale``/``bias`` become
    ``weight``/``bias``; the ``exit_head{s}`` matrices ``[C, classes]`` keep
    their layout.
    """
    sd: Dict[str, torch.Tensor] = {}

    def conv(key: str, hwio) -> None:
        sd[f"{key}.weight"] = _tensor(np.transpose(np.asarray(hwio),
                                                   (3, 2, 0, 1)))

    def norm(key: str, p) -> None:
        sd[f"{key}.weight"] = _tensor(p["scale"])
        sd[f"{key}.bias"] = _tensor(p["bias"])

    conv("stem", values_np["stem"])
    norm("stem_norm", values_np["stem_norm"])
    for s, n_blocks in enumerate(cfg.blocks):
        stage = values_np[f"layer{s + 1}"]
        if len(stage) != n_blocks:
            raise ValueError(f"layer{s + 1} has {len(stage)} blocks, the "
                             f"config {n_blocks}")
        for b, blk in enumerate(stage):
            prefix = f"layer{s + 1}.{b}"
            for name in ("conv1", "conv2", "conv3", "proj"):
                if name in blk:
                    conv(f"{prefix}.{name}", blk[name])
            for name in ("n1", "n2", "n3", "nproj"):
                if name in blk:
                    norm(f"{prefix}.{name}", blk[name])
    for s in range(4):
        sd[f"exit_head{s}"] = _tensor(values_np[f"exit_head{s}"])
    return sd


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def lm_params_from_jax(values_np: Dict[str, Any],
                       cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """The reference DecoderLM's value tree (numpy leaves; each segment's
    leaves stacked on a leading layers axis) -> the state dict of
    :class:`repro_torch.models.transformer.DecoderLM`.

    Segment ``i``'s stacked leaf ``attn.wq [n, D, H*Dh]`` becomes
    ``segments.{i}.{l}.attn.wq`` for each of its n layers; ``exit_norms`` is
    a list in both; ``lm_head`` exists only when the embeddings are untied.
    Matrices keep their ``[in, out]`` layout. Leaves come back float32;
    ``load_state_dict`` casts them to the model's dtype.
    """
    sd: Dict[str, torch.Tensor] = {"embed": _tensor(values_np["embed"])}
    for e, gain in enumerate(values_np["exit_norms"]):
        sd[f"exit_norms.{e}"] = _tensor(gain)
    if not cfg.tie_embeddings:
        sd["lm_head"] = _tensor(values_np["lm_head"])
    segs = cfg.segments()
    if len(values_np["segments"]) != len(segs):
        raise ValueError(f"{len(values_np['segments'])} segments, the config "
                         f"{len(segs)}")
    for i, ((_, start, end), seg) in enumerate(zip(segs,
                                                  values_np["segments"])):
        for path, stacked in _flatten(seg):
            stacked = np.asarray(stacked)
            if stacked.shape[0] != end - start:
                raise ValueError(f"segment {i} {path} stacks "
                                 f"{stacked.shape[0]} layers, the config "
                                 f"{end - start}")
            for layer in range(end - start):
                sd[f"segments.{i}.{layer}.{path}"] = _tensor(stacked[layer])
    return sd
