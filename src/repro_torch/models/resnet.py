"""The paper's own models: early-exit ResNet50/101/152 for CIFAR-100 as a
``torch.nn.Module`` (paper Sec. IV-A; reference ``src/repro/models/resnet.py``).

Structure: CIFAR stem (3x3 conv) + four bottleneck stages; an exit head
(spatial mean + one bias-free matmul) after each of layer1/layer2/layer3,
plus the final head after layer4. Exiting at point e runs only the stem,
stages <= e and that exit's head — the paper's latency lever. GroupNorm
stands in for BatchNorm, as in the reference: 8 groups
(``ResNetConfig.groups``), stepped down until they divide the channels,
biased variance, eps 1e-5, contiguous channel blocks.

Numerics policy: everything is float32. Convolutions reproduce XLA's SAME
padding, which pads (0, 1) for a 3x3 stride-2 conv on an even input where
PyTorch's ``padding=1`` would pad (1, 1). On CUDA, cuDNN runs float32 convs
in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False; this module
leaves both TF32 flags to the caller (``chip_smoke.py`` turns them off to
compute the float32 the reference computes). Inside, activations are NCHW;
the public ``forward_exit`` takes NHWC like the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import truncated_normal

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
STAGE_WIDTH = (64, 128, 256, 512)   # bottleneck base widths; expansion x4
EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    variant: str = "resnet50"
    num_classes: int = 100
    width_multiplier: float = 1.0   # reduced smoke configs use < 1
    blocks_override: Tuple[int, ...] = ()  # reduced smoke configs
    groups: int = 8                 # GroupNorm groups

    @property
    def blocks(self) -> Tuple[int, ...]:
        return self.blocks_override or STAGE_BLOCKS[self.variant]

    def widths(self) -> List[int]:
        return [max(int(w * self.width_multiplier), 8) for w in STAGE_WIDTH]

    @property
    def num_exits(self) -> int:
        return 4                    # layer1, layer2, layer3, final


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def norm_groups(c: int, groups: int) -> int:
    """The reference's group count: ``min(groups, c)``, stepped down until
    it divides ``c``."""
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


class SameConv2d(nn.Module):
    """Bias-free k x k conv with XLA SAME padding; weight OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(truncated_normal(
            (cout, cin, k, k), generator, scale=1.0 / math.sqrt(k * k * cin)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(x.shape[2], self.k, self.stride)
        pw = same_pads(x.shape[3], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, stride=self.stride,
                            padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, stride=self.stride)


def _norm(c: int, groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(norm_groups(c, groups), c, eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, cout: int, stride: int,
                 groups: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = SameConv2d(cin, width, 1, 1, generator)
        self.n1 = _norm(width, groups)
        self.conv2 = SameConv2d(width, width, 3, stride, generator)
        self.n2 = _norm(width, groups)
        self.conv3 = SameConv2d(width, cout, 1, 1, generator)
        self.n3 = _norm(cout, groups)
        self.proj: Optional[SameConv2d] = None
        self.nproj: Optional[nn.GroupNorm] = None
        if stride != 1 or cin != cout:
            self.proj = SameConv2d(cin, cout, 1, stride, generator)
            self.nproj = _norm(cout, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.n1(self.conv1(x)))
        h = F.relu(self.n2(self.conv2(h)))
        h = self.n3(self.conv3(h))
        if self.proj is not None:
            x = self.nproj(self.proj(x))
        return F.relu(x + h)


class EarlyExitResNet(nn.Module):
    """The paper's model family; exits = (layer1, layer2, layer3, final).

    Weights are drawn on the CPU from ``generator`` (default: seed 0) at the
    reference's scales, then the module moves to ``device`` (the card unless
    the caller passes ``"cpu"``).
    """

    def __init__(self, cfg: ResNetConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        widths = cfg.widths()
        self.stem = SameConv2d(3, widths[0], 3, 1, generator)
        self.stem_norm = _norm(widths[0], cfg.groups)
        cin = widths[0]
        for s, (n_blocks, width) in enumerate(zip(cfg.blocks, widths)):
            stage = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                cout = width * EXPANSION
                stage.append(Bottleneck(cin, width, cout, stride, cfg.groups,
                                        generator))
                cin = cout
            setattr(self, f"layer{s + 1}", nn.ModuleList(stage))
        for s in range(4):
            c_out = widths[s] * EXPANSION
            self.register_parameter(f"exit_head{s}", nn.Parameter(
                truncated_normal((c_out, cfg.num_classes), generator)))
        self.to(device)

    def forward_exit(self, x: torch.Tensor, exit_idx: int) -> torch.Tensor:
        """x ``[B, 32, 32, 3]`` (NHWC) -> float32 logits ``[B, classes]``,
        exiting after stage ``exit_idx`` (0..3). Only the included stages
        execute."""
        h = x.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        h = F.relu(self.stem_norm(self.stem(h)))
        for s in range(exit_idx + 1):
            for blk in getattr(self, f"layer{s + 1}"):
                h = blk(h)
        pooled = h.mean(dim=(2, 3))                       # adaptive avg pool
        return pooled @ getattr(self, f"exit_head{exit_idx}")

    def forward(self, x: torch.Tensor, exit_idx: int = 3) -> torch.Tensor:
        return self.forward_exit(x, exit_idx)
