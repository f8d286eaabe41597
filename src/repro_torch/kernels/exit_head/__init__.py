from repro_torch.kernels.exit_head.ops import exit_head

__all__ = ["exit_head"]
