"""Model configurations of the port."""

from repro_torch.configs.edgeserving_resnets import FULL, SMOKE

__all__ = ["FULL", "SMOKE"]
