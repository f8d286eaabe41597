"""The LM path's CUDA kernels and models (prefill and decode) on the card
against their plain versions on the CPU.

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
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.exit_head.ops import exit_head, exit_head_path
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


# (B, H, K, S, D): the three served prefills (B = 8, S = 128), Qwen3's at
# B = 1, S = 1, 77, 300 and 2048, D = 16 and 32, and S = 64 n +- 1
BF16_ATTENTION_SHAPES = [
    (8, 9, 3, 128, 64), (8, 24, 8, 128, 128), (8, 32, 8, 128, 128),
    (1, 32, 8, 128, 128),
    (2, 6, 2, 1, 64), (1, 32, 8, 77, 128), (1, 4, 2, 300, 16),
    (1, 8, 2, 2048, 128), (2, 4, 4, 100, 32),
    (2, 4, 2, 63, 64), (2, 4, 2, 65, 64), (1, 6, 3, 127, 128),
    (1, 6, 3, 129, 128), (1, 3, 3, 193, 32),
]


def _attention_inputs(rng, b, h, kh, s, d):
    """bfloat16 q ``[B, H, S, D]``, k and v ``[B, K, S, D]`` on the CPU."""
    return tuple(_randn(rng, b, n, s, d, dtype=torch.bfloat16)
                 for n in (h, kh, kh))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d", BF16_ATTENTION_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_cores_match_plain(card, b, h, kh, s, d,
                                                       causal):
    """The bfloat16 (tensor-core) kernel against the plain version, which
    runs on the card here so that S = 2048 stays quick."""
    rng = np.random.default_rng(1000 * s + h + d)
    q, k, v = (t.to(card) for t in _attention_inputs(rng, b, h, kh, s, d))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == 1 and got.dtype == q.dtype
    want = flash_attention_plain(q, k, v, causal=causal)
    _close(got, want.cpu(), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d", [(2, 50, 6, 2, 64),
                                        (1, 129, 32, 8, 128)])
def test_flash_attention_bf16_takes_heads_last_views_and_keeps_their_layout(
        card, b, s, h, kh, d):
    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, b, s, n, d, dtype=torch.bfloat16).to(card)
               for n in (h, kh, kh))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(*(t.cpu().transpose(1, 2) for t in (q, k, v)))
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q_offset", "k_position_stride",
                                   "v_head_stride"])
def test_flash_attention_bf16_refuses_rows_cp_async_cannot_copy(card, which):
    """A bfloat16 view whose rows are not 16-byte aligned raises
    ValueError before any launch; the wrapper copies nothing."""
    b, h, kh, s, d = 1, 4, 2, 70, 64
    rng = np.random.default_rng(5)
    q, k, v = (t.to(card) for t in _attention_inputs(rng, b, h, kh, s, d))
    if which == "q_offset":
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        q = buf[1:].view(q.shape).copy_(q)
    elif which == "k_position_stride":
        k = torch.cat([k, k[..., :1]], dim=-1)[..., :d]  # rows of D + 1
    else:
        wide = torch.zeros((b, kh + 1, s, d), dtype=v.dtype, device=card)
        v = torch.as_strided(wide, (b, kh, s, d),
                             (wide.stride(0), s * d + 4, d, 1))
    reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, k, v)
    assert launch_counts["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d", [(8, 32, 8, 128, 128),
                                        (2, 9, 3, 77, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_agrees_with_the_float32_kernel(card, b, h, kh,
                                                             s, d, causal):
    """The tensor-core kernel on bfloat16 inputs against the CUDA-core
    kernel on the same values in float32."""
    rng = np.random.default_rng(s + d)
    q, k, v = (t.to(card) for t in _attention_inputs(rng, b, h, kh, s, d))
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert want.dtype == torch.float32
    _close(got, want.cpu(), torch.bfloat16)


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


def _head_on_card(card, t, d, v, seed, dtype=torch.bfloat16):
    """Seeded h ``[T, D]``, gain ``[D]`` and w ``[D, V]`` on the card."""
    rng = np.random.default_rng(seed)
    return (_randn(rng, t, d, dtype=dtype).to(card),
            _randn(rng, d, scale=0.1, shift=1.0, dtype=dtype).to(card),
            _randn(rng, d, v, scale=d ** -0.5, dtype=dtype).to(card))


def _check_head(got, want):
    """max and lse within the float32 tolerance; the token equals the plain
    argmax or scores within that tolerance of the plain maximum."""
    (idx, mx, lse), (ridx, rmx, rlse) = got, want
    _close(mx, rmx.cpu(), torch.float32)
    _close(lse, rlse.cpu(), torch.float32)
    assert idx.dtype == torch.int32
    return idx, ridx, rmx


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 4, 8, 9, 17])
@pytest.mark.parametrize("d,v", [(576, 49152), (4096, 12800)])
def test_exit_head_tensor_cores_match_plain(card, t, d, v):
    """bfloat16 with 16-byte W rows runs on the tensor cores (hi/lo split
    rows), T > 8 as row groups; held against the plain version on the
    card."""
    h, g, w = _head_on_card(card, t, d, v, seed=t * 7 + d)
    assert exit_head_path(h, w) == "tensor_core"
    reset_launch_counts()
    got = exit_head(h, g, w)
    torch.cuda.synchronize()
    assert launch_counts["exit_head"] == 1
    idx, ridx, rmx = _check_head(got, exit_head_plain(h, g, w))
    picked = exit_head_logits(h, g, w).gather(1, idx.long()[:, None])[:, 0]
    assert bool(torch.all((idx == ridx) | (rmx - picked <= 2e-3)))


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [5, 3])
def test_exit_head_bf16_ragged_v_runs_on_the_cuda_cores(card, cut):
    """A bfloat16 W whose rows are not 16-byte aligned (V - 5, V - 3) takes
    the CUDA-core kernel, held against the plain version."""
    h, g, w = _head_on_card(card, 3, 576, 49152 - cut, seed=cut)
    assert exit_head_path(h, w) == "cuda_core"
    got = exit_head(h, g, w)
    idx, ridx, rmx = _check_head(got, exit_head_plain(h, g, w))
    picked = exit_head_logits(h, g, w).gather(1, idx.long()[:, None])[:, 0]
    assert bool(torch.all((idx == ridx) | (rmx - picked <= 2e-3)))


@pytest.mark.cuda
@pytest.mark.parametrize("cols,first", [([25599, 25600, 49151], 25599),
                                        ([5, 30000, 49151], 5),
                                        ([49023, 49024], 49023)])
def test_exit_head_tensor_core_ties_go_to_the_first_index(card, cols, first):
    """Equal maximal logits in different 128-column tiles (of one
    persistent block or of two) and across the last tile boundary: the
    smaller vocab index wins."""
    d, v = 16, 49152
    w = torch.zeros((d, v), dtype=torch.bfloat16, device=card)
    w[:, cols] = 1.0
    h = torch.ones((3, d), dtype=torch.bfloat16, device=card)
    assert exit_head_path(h, w) == "tensor_core"
    idx, _, _ = exit_head(h, torch.ones(d, dtype=torch.bfloat16,
                                        device=card), w)
    assert idx.tolist() == [first] * 3


# (S, cache layout): the model's views ([B, 1, H, D] q, [B, S, K, D] cache)
# or contiguous [B, K, S, D]; G = 8 query heads a kv head
DECODE_PLAN_SHAPES = [(s, layout) for s in (1, 31, 32, 33, 160, 1000, 4096)
                      for layout in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,cache_layout", DECODE_PLAN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_one_launch_matches_plain(card, s, cache_layout,
                                                   dtype):
    """G = 8 at every S of the launch plan (one block, one cluster of
    chunks), rows of lengths 0, 1, S and past S: the rows with a valid
    prefix against the plain version, the length-0 row exactly 0."""
    d = 128 if cache_layout else 64
    rng = np.random.default_rng(s * 2 + cache_layout)
    q, k, v, _ = _decode_inputs(rng, 4, 16, 2, s, d, dtype, cache_layout)
    lens = torch.tensor([0, 1, s, s + 9], dtype=torch.int32)
    reset_launch_counts()
    got = decode_attention(*(_on(card, t) for t in (q, k, v, lens)))
    torch.cuda.synchronize()
    assert launch_counts["decode_attention"] == 1 and got.dtype == dtype
    assert not bool(got[0].any())
    _close(got[1:], decode_attention_plain(q, k, v, lens)[1:], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d", [(8, 32, 8, 160, 128),
                                        (8, 32, 8, 4096, 128),
                                        (2, 16, 2, 1000, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_repeats_bitwise(card, b, h, kh, s, d, dtype):
    """The chunks fold in a fixed order: two calls on the same inputs give
    the same bits."""
    rng = np.random.default_rng(s + d)
    args = [_on(card, t) for t in _decode_inputs(rng, b, h, kh, s, d, dtype,
                                                 True)]
    first = decode_attention(*args)
    second = decode_attention(*args)
    assert torch.equal(first, second)


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
    (+ L_e for q/k norm, q and k in one launch), flash attention L_e and the
    exit head once."""
    cfg = get_config("qwen3-8b", smoke=True)
    (mod,) = serve_lms({"q": cfg}, device=card, prompt_len=16, max_batch=4)
    run_quantum(mod, 1, 4)
    reset_launch_counts()
    idx, _, _ = run_quantum(mod, 1, 4)
    layers = cfg.exits[1]
    assert idx.shape == (4,)
    assert launch_counts["rmsnorm"] == 3 * layers
    assert launch_counts["flash_attention"] == layers
    assert launch_counts["exit_head"] == 1


def _decode_inputs(rng, b, h, kh, s, d, dtype, cache_layout):
    """q ``[B, H, D]``, k, v ``[B, K, S, D]`` and per-row lengths in [1, S]
    (the last row S) on the CPU; with ``cache_layout`` q and k, v are the
    model's views (``[B, 1, H, D][:, 0]``, ``[B, S, K, D]`` transposed)."""
    if cache_layout:
        q = _randn(rng, b, 1, h, d, dtype=dtype)[:, 0]
        k, v = (_randn(rng, b, s, kh, d, dtype=dtype).transpose(1, 2)
                for _ in range(2))
    else:
        q = _randn(rng, b, h, d, dtype=dtype)
        k, v = (_randn(rng, b, kh, s, d, dtype=dtype) for _ in range(2))
    lens = rng.integers(1, s + 1, b)
    lens[-1] = s
    return q, k, v, torch.from_numpy(lens.astype(np.int32))


def _on(card, t):
    """``t`` on the card with the same strides (a view stays a view)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=card).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,s,d,cache_layout", [
    (1, 9, 3, 160, 64, True), (8, 9, 3, 160, 64, True),      # SmolLM-135M
    (1, 24, 8, 160, 128, True), (8, 24, 8, 160, 128, True),  # Phi-4-mini
    (1, 32, 8, 160, 128, True), (8, 32, 8, 160, 128, True),  # Qwen3-8B
    (2, 32, 8, 4096, 128, True),                             # long cache
    (3, 4, 2, 77, 32, False), (2, 16, 2, 1000, 16, False),   # ragged S, G=8
    (2, 6, 2, 1, 64, False),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_plain(card, b, h, kh, s, d, cache_layout,
                                        dtype):
    rng = np.random.default_rng(s + h)
    q, k, v, lens = _decode_inputs(rng, b, h, kh, s, d, dtype, cache_layout)
    reset_launch_counts()
    got = decode_attention(*(_on(card, t) for t in (q, k, v, lens)))
    torch.cuda.synchronize()
    assert launch_counts["decode_attention"] == 1 and got.dtype == dtype
    _close(got, decode_attention_plain(q, k, v, lens), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_lengths_and_tail(card, dtype):
    """Length 1 reads the first value; a length past S reads all of S; K/V
    past the length (set to +-1e4) change nothing; length 0 gives 0, as
    the Pallas kernel does."""
    rng = np.random.default_rng(3)
    q, k, v, _ = _decode_inputs(rng, 4, 8, 2, 100, 32, dtype, False)
    lens = torch.tensor([1, 101, 40, 0], dtype=torch.int32)
    qc, kc, vc, lc = (t.to(card) for t in (q, k, v, lens))
    got = decode_attention(qc, kc, vc, lc)
    want = decode_attention_plain(q, k, v, lens)
    _close(got[:3], want[:3], dtype)
    assert not bool(got[3].any())
    kc[:, :, 40:] = 1e4
    vc[:, :, 40:] = -1e4
    kc[0, :, 1:], vc[0, :, 1:] = 1e4, -1e4
    tail = decode_attention(qc, kc, vc, lc)
    assert torch.equal(tail[0], got[0]) and torch.equal(tail[2], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_decode_on_card_matches_cpu(card, arch):
    """Prefill, then 6 decode steps of the SMOKE model on the card against
    the same weights on the CPU, in logits and caches; each step launches
    decode attention L_e times and rmsnorm 2 L_e (+L_e: q and k in one
    launch) + 1 times."""
    cfg = get_config(arch, smoke=True)
    model = DecoderLM(cfg, generator=torch.Generator(card).manual_seed(0),
                      device=card)
    twin = DecoderLM(cfg, device="cpu")
    twin.load_state_dict(model.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    e = cfg.num_exits - 1
    layers = cfg.exits[e]
    caches = []
    with torch.inference_mode():
        for m in (model, twin):
            dev = m.embed.device
            _, pref = m.prefill({"tokens": tokens[:, :10].to(dev)}, e)
            cache = m.init_cache(2, 19, e)
            for buf, seg in zip(cache["segments"], pref["segments"]):
                buf["k"][:, :, :10] = seg["k"]
                buf["v"][:, :, :10] = seg["v"]
                buf["len"][:] = seg["len"]
            caches.append(cache)
        for i in range(10, 16):
            reset_launch_counts()
            got, caches[0] = model.decode_step(tokens[:, i:i + 1].to(card),
                                               caches[0], e)
            torch.cuda.synchronize()
            assert launch_counts["decode_attention"] == layers
            assert launch_counts["rmsnorm"] == layers * (
                3 if cfg.qk_norm else 2) + 1
            want, caches[1] = twin.decode_step(tokens[:, i:i + 1], caches[1],
                                               e)
            _close(got, want, torch.float32)
    for g, w in zip(*(c["segments"] for c in caches)):
        _close(g["k"], w["k"], torch.float32)
        _close(g["v"], w["v"], torch.float32)
        assert torch.equal(g["len"].cpu(), w["len"])
