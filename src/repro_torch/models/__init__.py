"""Model zoo of the port. This slice carries the paper's early-exit ResNets."""

from repro_torch.models.convert import resnet_params_from_jax
from repro_torch.models.resnet import EarlyExitResNet, ResNetConfig

__all__ = ["EarlyExitResNet", "ResNetConfig", "resnet_params_from_jax"]
