"""The model zoo's kernel shapes and SMOKE models on the card against their
plain versions on the CPU.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_zoo_cuda.py

Every test needs a card and skips without one. Tolerances are those of
``tests/test_kernels.py:22-23``.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.exit_head.ops import exit_head, exit_head_path
from repro_torch.kernels.exit_head.ref import exit_head_plain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
from repro_torch.models import build_model
from repro_torch.runtime.server import run_quantum, serve_lms

TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
DTYPES = [torch.float32, torch.bfloat16]
ZOO = ("deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b",
       "rwkv6-1.6b", "seamless-m4t-large-v2", "starcoder2-7b",
       "llava-next-mistral-7b")


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
@pytest.mark.parametrize("t,d", [(64, 7168), (64, 1536), (64, 512),
                                 (32768, 64), (32, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_zoo_rows_match_plain(card, t, d, dtype):
    """V3's residual and latent norms, RWKV's per-head norm (B = 8 x S =
    128 x H = 32 rows of 64, and a decode step's 32)."""
    rng = np.random.default_rng(t + d)
    x = _randn(rng, t, d, scale=3.0, dtype=dtype)
    g = _randn(rng, d, scale=0.2, shift=1.0, dtype=dtype)
    _close(rmsnorm(x.to(card), g.to(card)), rmsnorm_plain(x, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d,causal", [
    (2, 36, 4, 77, 128, True),      # StarCoder2: G = 9
    (2, 16, 16, 77, 128, True),     # DeepSeek-MoE: G = 1
    (2, 16, 16, 1024, 64, False),   # the Seamless encoder
    (2, 16, 16, 77, 64, True),      # the Seamless decoder
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_zoo_shapes_match_plain(card, b, h, kh, s, d, causal,
                                                dtype):
    rng = np.random.default_rng(s + h)
    q = _randn(rng, b, s, h, d, dtype=dtype).transpose(1, 2)
    k = _randn(rng, b, s, kh, d, dtype=dtype).transpose(1, 2)
    v = _randn(rng, b, s, kh, d, dtype=dtype).transpose(1, 2)
    got = flash_attention(q.to(card), k.to(card), v.to(card), causal=causal)
    _close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d", [
    (1, 36, 4, 144, 128), (8, 36, 4, 144, 128),   # G = 9
    (1, 16, 16, 144, 128),                        # G = 1
    (1, 16, 16, 144, 64), (2, 16, 16, 1024, 64),  # Seamless self, cross
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_zoo_shapes_match_plain(card, b, h, kh, s, d,
                                                 dtype):
    rng = np.random.default_rng(b * s + h)
    q = _randn(rng, b, 1, h, d, dtype=dtype)[:, 0]
    k = _randn(rng, b, s, kh, d, dtype=dtype).transpose(1, 2)
    v = _randn(rng, b, s, kh, d, dtype=dtype).transpose(1, 2)
    lens = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32))
    lens[-1] = s
    got = decode_attention(*(t.to(card) for t in (q, k, v, lens)))
    _close(got, decode_attention_plain(q, k, v, lens), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,v", [(2, 7168, 129280), (2, 1024, 256206),
                                   (3, 2048, 102400)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_exit_head_zoo_shapes_match_plain(card, t, d, v, dtype):
    """V3's D = 7168 head, Seamless's V = 256206 (bfloat16 rows of 512412
    bytes: the CUDA-core first pass) and DeepSeek-MoE's."""
    rng = np.random.default_rng(d)
    h = _randn(rng, t, d, dtype=dtype)
    g = _randn(rng, d, scale=0.1, shift=1.0, dtype=dtype)
    w = _randn(rng, d, v, scale=d ** -0.5, dtype=dtype)
    idx, mx, lse = exit_head(h.to(card), g.to(card), w.to(card))
    w_idx, w_mx, w_lse = exit_head_plain(h, g, w)
    np.testing.assert_allclose(mx.cpu().numpy(), w_mx.numpy(), **TOL[
        torch.float32])
    np.testing.assert_allclose(lse.cpu().numpy(), w_lse.numpy(), **TOL[
        torch.float32])
    if dtype == torch.float32:
        assert torch.equal(idx.cpu(), w_idx)
    if v == 256206 and dtype == torch.bfloat16:
        assert exit_head_path(h.to(card), w.to(card)) == "cuda_core"


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    if cfg.family == "encdec":
        return {"src_embeds": _randn(rng, b, cfg.frontend_seq, cfg.d_model),
                "tokens": tokens}
    if cfg.frontend == "vision":
        return {"embeds": _randn(rng, b, s, cfg.d_model)}
    return {"tokens": tokens}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO)
def test_smoke_family_on_card_matches_cpu(card, arch):
    """The SMOKE model on the card (kernels) against the same weights on
    the CPU (plain versions): every exit's logits and exit decision, then a
    prefill and 4 decode steps."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, generator=torch.Generator(card).manual_seed(0),
                        device=card)
    twin = copy.deepcopy(model).to("cpu")
    batch = _batch(cfg, 2, 13, seed=len(arch))
    on_card = {k: v.to(card) for k, v in batch.items()}
    with torch.inference_mode():
        for e in range(cfg.num_exits):
            _close(model.forward_exit(on_card, e),
                   twin.forward_exit(batch, e), torch.float32)
            got = model.exit_decision(on_card, e)
            want = twin.exit_decision(batch, e)
            for g, w in zip(got[1:], want[1:]):
                _close(g, w, torch.float32)
        e = cfg.num_exits - 1
        steps = []
        for m, b in ((model, on_card), (twin, batch)):
            prompt = {k: (v if k == "src_embeds" else v[:, :9])
                      for k, v in b.items()}
            logits, pref = m.prefill(prompt, e)
            cache = cache_copy(m, b, pref, e)
            out = [logits]
            for i in range(9, 13):
                tok = (b["embeds"][:, i:i + 1] if "embeds" in b
                       else b["tokens"][:, i:i + 1])
                logits, cache = m.decode_step(tok, cache, e)
                out.append(logits)
            steps.append(torch.cat(out, 1))
    _close(steps[0], steps[1], torch.float32)


def cache_copy(model, batch, pref, e, prompt=9, max_len=16):
    """``init_cache`` buffers holding a prefill's caches: position-indexed
    leaves at positions < prompt, the rest whole."""
    kw = ({"src_len": batch["src_embeds"].shape[1]}
          if model.cfg.family == "encdec" else {})
    buf = model.init_cache(2, max_len, e, **kw)

    def fill(b, p):
        if isinstance(b, dict):
            for key in b:
                fill(b[key], p[key])
        elif isinstance(b, list):
            for x, y in zip(b, p):
                fill(x, y)
        elif b.shape == p.shape:
            b.copy_(p)
        else:
            b[:, :, :prompt] = p

    fill(buf, pref)
    return buf


def _implied(cfg, e):
    """rmsnorm, flash-attention and exit-head launches of one quantum at
    exit e (chip_smoke.implied_launches)."""
    layers = cfg.exits[e]
    if cfg.family == "rwkv":
        norms, attn = 3 * layers, 0
    elif cfg.family == "jamba":
        norms, attn = 2 * layers, layers // cfg.attn_period
    elif cfg.family == "encdec":
        norms = 3 * layers + 2 * cfg.num_encoder_layers + 1
        attn = layers + cfg.num_encoder_layers
    elif cfg.mla:
        norms, attn = 4 * layers, 0
    else:
        norms, attn = 2 * layers, layers
    return {"rmsnorm": norms, "flash_attention": attn, "exit_head": 1,
            "decode_attention": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO)
def test_served_quantum_launches_as_the_family_implies(card, arch):
    cfg = get_config(arch, smoke=True)
    (mod,) = serve_lms({arch: cfg}, device=card, prompt_len=16, max_batch=4)
    for e in range(cfg.num_exits):
        run_quantum(mod, e, 4)
        reset_launch_counts()
        idx, _, _ = run_quantum(mod, e, 4)
        assert idx.shape == (4,)
        assert {k: launch_counts[k] for k in _implied(cfg, e)} == _implied(
            cfg, e)
