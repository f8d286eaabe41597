"""The LM path's CUDA kernels and models on the card against their plain
versions on the CPU.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_cuda.py

Every test needs a card and skips without one. Tolerances are those of
``tests/test_kernels.py:22-23``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.exit_head.ops import exit_head
from repro_torch.kernels.exit_head.ref import exit_head_logits, exit_head_plain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
from repro_torch.models import DecoderLM
from repro_torch.runtime.server import run_quantum, serve_lms

TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    a = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(7, 128), (1024, 4096), (5, 4097),
                                 (32768, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches_plain(card, t, d, dtype):
    rng = np.random.default_rng(d)
    x = _randn(rng, t, d, scale=3.0, dtype=dtype)
    g = _randn(rng, d, scale=0.2, shift=1.0, dtype=dtype)
    reset_launch_counts()
    got = rmsnorm(x.to(card), g.to(card))
    torch.cuda.synchronize()
    assert launch_counts["rmsnorm"] == 1 and got.dtype == dtype
    _close(got, rmsnorm_plain(x, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d", [(2, 9, 3, 128, 64),
                                        (1, 32, 8, 77, 128),
                                        (1, 4, 2, 300, 16), (2, 4, 4, 1, 32)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(card, b, h, kh, s, d, dtype, causal):
    rng = np.random.default_rng(s)
    q = _randn(rng, b, h, s, d, dtype=dtype)
    k = _randn(rng, b, kh, s, d, dtype=dtype)
    v = _randn(rng, b, kh, s, d, dtype=dtype)
    reset_launch_counts()
    got = flash_attention(q.to(card), k.to(card), v.to(card), causal=causal)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1
    _close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
def test_flash_attention_takes_heads_last_views_and_keeps_their_layout(card):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, 2, 50, n, 64).to(card) for n in (6, 2, 2))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(*(t.cpu().transpose(1, 2) for t in (q, k, v)))
    _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,v", [(1, 576, 49152), (2, 576, 49152),
                                   (8, 576, 49152), (3, 3072, 200064),
                                   (1, 96, 1001), (9, 64, 300)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_exit_head_matches_plain(card, t, d, v, dtype):
    """max and lse are float32 outputs in either input dtype, held at the
    float32 tolerance; the token equals the plain argmax in float32, and in
    bfloat16 equals it or scores within that tolerance of the maximum."""
    rng = np.random.default_rng(v)
    h = _randn(rng, t, d, dtype=dtype)
    g = _randn(rng, d, scale=0.1, shift=1.0, dtype=dtype)
    w = _randn(rng, d, v, scale=d ** -0.5, dtype=dtype)
    reset_launch_counts()
    idx, mx, lse = exit_head(h.to(card), g.to(card), w.to(card))
    torch.cuda.synchronize()
    assert launch_counts["exit_head"] == 1
    ridx, rmx, rlse = exit_head_plain(h, g, w)
    _close(mx, rmx, torch.float32)
    _close(lse, rlse, torch.float32)
    idx = idx.cpu()
    if dtype == torch.float32:
        assert torch.equal(idx, ridx)
    else:
        picked = exit_head_logits(h, g, w).gather(1, idx.long()[:, None])[:, 0]
        tol = TOL[torch.float32]["atol"]
        assert bool(torch.all((idx == ridx) | (rmx - picked <= tol)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_exit_head_ties_go_to_the_first_index(card, dtype):
    d, v = 16, 1024
    w = torch.zeros((d, v), dtype=dtype)
    w[:, [127, 128, 255, 256]] = 1.0
    idx, _, _ = exit_head(torch.ones((2, d), dtype=dtype, device=card),
                          torch.ones(d, dtype=dtype, device=card), w.to(card))
    assert idx.tolist() == [127, 127]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_lm_on_card_matches_cpu(card, arch):
    """The SMOKE model on the card (kernels) against the same weights on
    the CPU (plain versions), every exit."""
    cfg = get_config(arch, smoke=True)
    model = DecoderLM(cfg, generator=torch.Generator(card).manual_seed(0),
                      device=card)
    twin = DecoderLM(cfg, device="cpu")
    twin.load_state_dict(model.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 37)))
    for e in range(cfg.num_exits):
        with torch.inference_mode():
            got = model.forward_exit({"tokens": tokens.to(card)}, e)
            want = twin.forward_exit({"tokens": tokens}, e)
            g_top = model.exit_decision({"tokens": tokens.to(card)}, e)
            w_top = twin.exit_decision({"tokens": tokens}, e)
        _close(got, want, torch.float32)
        assert torch.equal(g_top[0].cpu(), w_top[0])
        _close(g_top[2], w_top[2], torch.float32)


@pytest.mark.cuda
def test_served_quantum_launches_each_kernel(card):
    """One served quantum of the Qwen3 SMOKE model launches rmsnorm 2 L_e
    (+ 2 L_e for q/k norm), flash attention L_e and the exit head once."""
    cfg = get_config("qwen3-8b", smoke=True)
    (mod,) = serve_lms({"q": cfg}, device=card, prompt_len=16, max_batch=4)
    run_quantum(mod, 1, 4)
    reset_launch_counts()
    idx, _, _ = run_quantum(mod, 1, 4)
    layers = cfg.exits[1]
    assert idx.shape == (4,)
    assert launch_counts["rmsnorm"] == 4 * layers
    assert launch_counts["flash_attention"] == layers
    assert launch_counts["exit_head"] == 1
