from repro_torch.kernels.stability_score.ops import stability_scores

__all__ = ["stability_scores"]
