"""The port's ``train_loss`` against the reference's on the CPU, for every
LM family (the reference's ``tiny_cfg``, ``tests/test_models.py:19``: dense,
MoE with its aux loss, RWKV-6, Jamba, the encoder-decoder), for MLA, a
vision frontend and Qwen3's q/k norm pair (their SMOKE configs) (the
ResNets: ``test_torch_train_loss_resnet.py``): the loss and every
``nll_exit{i}`` at rtol 1e-5, and
the gradient of every parameter, carried across by name, against
``jax.grad`` at 2e-3 * (1 + the leaf's largest gradient) (``torch_train``).
No parameter may be left without a gradient.

On the CPU the port's norms and attention run their autograd Functions'
plain forward and plain backward (``rmsnorm_bwd_plain``,
``flash_attention_bwd_plain``), so this holds those formulas and the
Functions' plumbing (saved tensors, the GQA group sum, the gain's
gradient) against XLA's autodiff of the reference's jnp forms.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config

from repro_torch.kernels import launch_counts
from repro_torch.models.common import prefix_rotation

from torch_train import (
    LOSS_RTOL,
    LMPair,
    assert_grad_close,
    port_loss_and_grads,
    ref_loss_and_grads,
    tiny_cfg,
    to_torch,
)

torch.set_num_threads(1)

CASES = {
    "dense": lambda: tiny_cfg("dense"),
    "moe": lambda: tiny_cfg("moe"),
    "rwkv": lambda: tiny_cfg("rwkv"),
    "jamba": lambda: tiny_cfg("jamba"),
    "encdec": lambda: tiny_cfg("encdec"),
    "dense_remat": lambda: tiny_cfg("dense", remat="dots"),
    "dense_padded_vocab": lambda: tiny_cfg("dense", vocab_pad_multiple=16),
    "mla": lambda: ref_get_config("deepseek-v3-671b", smoke=True),
    "vision": lambda: ref_get_config("llava-next-mistral-7b", smoke=True),
    "qk_norm": lambda: ref_get_config("qwen3-8b", smoke=True),
    "tied": lambda: ref_get_config("smollm-135m", smoke=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def lm_case(request):
    pair = LMPair(CASES[request.param](), seed=len(request.param))
    want = ref_loss_and_grads(pair)
    got = port_loss_and_grads(pair.port, to_torch(pair.batch_np))
    return request.param, pair, want, got


def test_loss_and_metrics_match_reference(lm_case):
    _, pair, (ref_loss, ref_metrics, _), (loss, metrics, _) = lm_case
    assert set(metrics) == set(ref_metrics)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss.detach()), ref_loss,
                               rtol=LOSS_RTOL)
    for key, want in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[key].detach()), want,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)


def test_every_parameter_gradient_matches_reference(lm_case):
    _, pair, (_, _, ref_grads), (_, _, grads) = lm_case
    assert set(grads) == set(ref_grads)
    # a parameter the loss does not reach (the embedding under a vision
    # frontend's embeds) has no gradient, where the reference's is zeros
    missing = [n for n, g in grads.items()
               if g is None and np.any(ref_grads[n] != 0)]
    assert not missing, f"parameters without a gradient: {missing}"
    for name, want in ref_grads.items():
        got = grads[name]
        assert_grad_close(name, np.zeros_like(want) if got is None
                          else got.numpy(), want)


def test_padded_vocab_columns_get_exactly_zero_gradient():
    pair = LMPair(tiny_cfg("dense", vocab_pad_multiple=16), seed=3)
    cfg = pair.cfg
    assert cfg.vocab_padded > cfg.vocab_size
    _, _, grads = port_loss_and_grads(pair.port, to_torch(pair.batch_np))
    pad = grads["lm_head"][:, cfg.vocab_size:]
    assert torch.count_nonzero(pad) == 0
    assert torch.count_nonzero(grads["lm_head"][:, :cfg.vocab_size]) > 0


def test_tied_embedding_gets_lookup_and_unembedding_gradient():
    """SmolLM's tied ``embed`` collects the gradient of the lookup and of
    the unembedding; the exit head's contiguous copy stays out of it."""
    pair = LMPair(ref_get_config("smollm-135m", smoke=True), seed=4)
    model = pair.port
    assert model._head_w is None
    _, _, grads = port_loss_and_grads(model, to_torch(pair.batch_np))
    seen = np.unique(pair.batch_np["tokens"])
    unseen = np.setdiff1d(np.arange(pair.cfg.vocab_size), seen)
    g = grads["embed"]
    # rows never looked up still get the unembedding's gradient
    assert torch.count_nonzero(g[torch.from_numpy(unseen)]) > 0
    assert model._head_w is None
    assert "lm_head" not in grads


def test_train_loss_under_inference_takes_the_direct_path():
    """Without autograd the norms and attention take their direct path and
    the loss equals the graph's."""
    pair = LMPair(tiny_cfg("dense"), seed=5)
    batch = to_torch(pair.batch_np)
    with torch.inference_mode():
        loss_inf, _ = pair.port.train_loss(batch)
    loss, _, _ = port_loss_and_grads(pair.port, batch)
    assert float(loss_inf) == float(loss.detach())


def test_training_after_serving_the_same_shapes():
    """A rotation cached while serving (under ``torch.inference_mode``)
    must not break a later backward over the same shapes."""
    prefix_rotation.cache_clear()
    pair = LMPair(tiny_cfg("dense"), seed=8)
    batch = to_torch(pair.batch_np)
    with torch.inference_mode():
        served = pair.port.forward_exit(batch, pair.cfg.num_exits - 1)
    assert served.is_inference()
    _, _, grads = port_loss_and_grads(pair.port, batch)
    assert all(g is not None for g in grads.values())


def test_cpu_backward_launches_no_kernel():
    pair = LMPair(tiny_cfg("dense"), seed=6)
    before = dict(launch_counts)
    port_loss_and_grads(pair.port, to_torch(pair.batch_np))
    assert dict(launch_counts) == before
