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
