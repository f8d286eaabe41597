"""The benchmark's plain reference (``bench/reference/lm.py``) against the
port's CPU path at the SMOKE configs, every exit, with the unembedding
tied to the input embedding and not, on weights drawn by the benchmark's
own set-up."""

from __future__ import annotations

import pytest
import torch

from smallcfg import lm_dict
from harness import deploy
from reference import lm as ref_lm
from repro_torch.models import build_model
from repro_torch.models.common import set_params

ARCHS = ("phi4-mini-3.8b", "starcoder2-7b", "seamless-m4t-large-v2")
TOL = 2e-4  # float32 on both sides; the port's order of sums differs


def _served(arch: str, seed: int = 5, tied: bool = False):
    lm = dict(lm_dict(arch), tie_embeddings=tied)
    cfg = deploy.lm_config(lm)
    gen = torch.Generator().manual_seed(seed)
    weights = deploy.draw_weights(cfg, gen, torch.device("cpu"))
    pool = deploy.PromptPool(cfg, 3, 12, gen, torch.device("cpu"))
    model = build_model(cfg, device="meta")
    set_params(model, weights)
    return lm, cfg, weights, pool, model.eval()


@pytest.mark.parametrize("tied", (False, True), ids=("untied", "tied"))
@pytest.mark.parametrize("exit_idx", range(4))
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_matches_port(arch, exit_idx, tied):
    lm, cfg, weights, pool, model = _served(arch, tied=tied)
    assert ("lm_head" in weights) is not tied
    batch = pool.rows(0, 3)
    with torch.inference_mode():
        want = model.forward_exit(batch, exit_idx)[:, -1]
        token, mx, lse = model.exit_decision(batch, exit_idx)
        got = ref_lm.exit_logits(weights, lm, batch["tokens"],
                                 [exit_idx] * 3, src=batch.get("src_embeds"))
    got = torch.stack(got)
    scale = want.abs().max()
    assert torch.allclose(got, want, atol=TOL * scale, rtol=0)
    assert torch.equal(got.argmax(-1).to(torch.int32), token)
    assert torch.allclose(torch.logsumexp(got, -1), lse, atol=TOL * scale)
    assert torch.allclose(got.max(-1).values, mx, atol=TOL * scale)


def test_fp8_control_departs_from_float32():
    """The control's float8 products move the logits by far more than
    float32 rounding."""
    lm, cfg, weights, pool, _ = _served("phi4-mini-3.8b")
    batch = pool.rows(0, 3)
    with torch.inference_mode():
        ref = torch.stack(ref_lm.exit_logits(weights, lm, batch["tokens"],
                                             [3] * 3))
        low = torch.stack(ref_lm.exit_logits(weights, lm, batch["tokens"],
                                             [3] * 3, fp8=True))
    assert (low - ref).abs().max() > 100 * TOL * ref.abs().max()
