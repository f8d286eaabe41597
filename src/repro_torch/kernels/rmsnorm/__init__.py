from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_pair

__all__ = ["rmsnorm", "rmsnorm_pair"]
