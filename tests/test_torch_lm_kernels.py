"""The port's LM kernels (rmsnorm, flash attention, the fused exit head)
against the JAX reference on the CPU.

Each wrapper given CPU tensors runs its plain version; it is held against
the reference's Pallas kernel in interpret mode at shapes of
``tests/test_kernels.py``, and against the reference's jnp oracle at ragged
shapes the Pallas kernels refuse (S or V not a multiple of the block).
Inputs are made with numpy from a seed and fed to both sides. The CUDA
kernels against these plain versions: ``tests/test_torch_lm_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.exit_head.ops import exit_head as ref_exit_head
from repro.kernels.exit_head.ref import exit_head_ref
from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm as ref_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref

from repro_torch.kernels import checks, launch_counts, reset_launch_counts
from repro_torch.kernels.exit_head.ops import confidence_from, exit_head
from repro_torch.kernels.exit_head.ref import (
    exit_head_logits,
    exit_head_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

torch.set_num_threads(1)

# tests/test_kernels.py:22-23
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """The same float32 numpy array as a JAX and a torch array of
    ``dtype`` (both round to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,d,bt", [(8, 64, 8), (32, 512, 8), (16, 96, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpret(t, d, bt, dtype):
    rng = np.random.default_rng(t * 1000 + d)
    x_j, x_t = _both(rng.normal(size=(t, d)).astype(np.float32), dtype)
    g_j, g_t = _both((rng.normal(size=d) * 0.2 + 1).astype(np.float32), dtype)
    want = ref_rmsnorm(x_j, g_j, block_t=bt, interpret=True)
    got = rmsnorm(x_t, g_t)
    assert got.dtype == x_t.dtype and got.shape == (t, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("t,d", [(7, 128), (3, 4096), (130, 576)])
def test_rmsnorm_plain_matches_reference_at_ragged_rows(t, d):
    """Row counts the Pallas kernel's tiling refuses; D up to 4096."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(t, d)).astype(np.float32) * 3
    g = (rng.normal(size=d) * 0.2 + 1).astype(np.float32)
    want = rmsnorm_ref(jnp.asarray(x), jnp.asarray(g), 1e-6)
    got = rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _qkv(rng, b, h, kh, s, d, dtype):
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, kh, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kh, s, d)).astype(np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("b,h,kh,s,d", [(2, 4, 2, 128, 64),
                                        (1, 2, 2, 64, 128),
                                        (2, 2, 1, 192, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(b, h, kh, s, d, dtype, causal):
    rng = np.random.default_rng(b + h + s + d)
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _qkv(rng, b, h, kh, s, d, dtype)
    want = ref_flash(q_j, k_j, v_j, causal=causal, block_q=64, block_k=64,
                     interpret=True)
    got = flash_attention(q_t, k_t, v_t, causal=causal)
    assert got.dtype == q_t.dtype and got.shape == (b, h, s, d)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("b,h,kh,s,d", [(1, 9, 3, 37, 64),
                                        (2, 4, 1, 130, 32),
                                        (1, 8, 2, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_at_ragged_s(b, h, kh, s, d, dtype):
    """S that no Pallas block divides; GQA groups 3 and 4."""
    rng = np.random.default_rng(s)
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _qkv(rng, b, h, kh, s, d, dtype)
    want = flash_attention_ref(q_j, k_j, v_j, causal=True)
    got = flash_attention_plain(q_t, k_t, v_t, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_flash_accepts_strided_heads_last_views():
    """The model hands ``[B, S, H, D]`` activations over as transposed
    views; the result equals the contiguous call's."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 40, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    views = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    dense = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous())
    np.testing.assert_allclose(views.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-6)


def _bf16_view(kind):
    """A bfloat16 [B, H, S, D] tensor laid out as ``kind`` says."""
    b, h, s, d = 2, 4, 70, 64
    if kind == "model_view":   # [B, S, H, D] transposed
        return torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)
    if kind == "contiguous":
        return torch.zeros((b, h, s, d), dtype=torch.bfloat16)
    if kind == "unit_dims_odd_strides":  # B = H = 1: their strides unused
        base = torch.zeros(s * d, dtype=torch.bfloat16)
        return torch.as_strided(base, (1, 1, s, d), (3, 5, d, 1))
    if kind == "offset_by_one":
        n = b * h * s * d
        return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(b, h, s, d)
    if kind == "position_stride_d_plus_1":
        return torch.zeros((b, h, s, d + 1), dtype=torch.bfloat16)[..., :d]
    base = torch.zeros(b * (h + 1) * s * d, dtype=torch.bfloat16)
    return torch.as_strided(base, (b, h, s, d),       # head stride 4484
                            ((h + 1) * s * d, s * d + 4, d, 1))


@pytest.mark.parametrize("kind,ok", [
    ("model_view", True), ("contiguous", True),
    ("unit_dims_odd_strides", True), ("offset_by_one", False),
    ("position_stride_d_plus_1", False), ("head_stride_not_8", False)])
def test_bf16_kernel_row_alignment_check(kind, ok):
    """The check the wrapper runs on bfloat16 q, k, v before the
    tensor-core kernel (16-byte cp.async rows); on the CPU it is called
    directly, since a CPU tensor never reaches it."""
    t = _bf16_view(kind)
    if ok:
        checks.require_16_byte_rows(t, "q")
    else:
        with pytest.raises(ValueError, match="16 bytes"):
            checks.require_16_byte_rows(t, "q")

# ---------------------------------------------------------------------------
# exit head
# ---------------------------------------------------------------------------


def _head_inputs(rng, t, d, v, dtype):
    h = rng.normal(size=(t, d)).astype(np.float32)
    g = (rng.normal(size=d) * 0.1 + 1.0).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    return [_both(a, dtype) for a in (h, g, w)]


def _assert_head_close(got, want, dtype):
    idx, mx, lse = got
    ridx, rmx, rlse = want
    assert idx.dtype == torch.int32 and mx.dtype == torch.float32
    np.testing.assert_allclose(mx.numpy(), _f32(rmx), **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), _f32(rlse), **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))


@pytest.mark.parametrize("t,d,v,bt,bv", [(8, 64, 512, 8, 128),
                                         (16, 128, 1024, 8, 256),
                                         (4, 32, 256, 4, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exit_head_plain_matches_pallas_interpret(t, d, v, bt, bv, dtype):
    rng = np.random.default_rng(t + d + v)
    (h_j, h_t), (g_j, g_t), (w_j, w_t) = _head_inputs(rng, t, d, v, dtype)
    want = ref_exit_head(h_j, g_j, w_j, block_t=bt, block_v=bv,
                         interpret=True)
    _assert_head_close(exit_head(h_t, g_t, w_t), want, dtype)


@pytest.mark.parametrize("t,d,v", [(1, 576, 1000), (3, 96, 2049),
                                   (8, 64, 200064 // 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exit_head_plain_matches_reference_at_ragged_v(t, d, v, dtype):
    """V that no Pallas vocab block divides (Phi-4-mini's 200064 is not a
    multiple of 1024)."""
    rng = np.random.default_rng(v)
    (h_j, h_t), (g_j, g_t), (w_j, w_t) = _head_inputs(rng, t, d, v, dtype)
    _assert_head_close(exit_head_plain(h_t, g_t, w_t),
                       exit_head_ref(h_j, g_j, w_j), dtype)


def test_exit_head_argmax_is_first_on_ties_across_a_tile_boundary():
    """Equal maximal logits on both sides of the kernel's 128/256-column
    tile boundaries: the smaller vocab index wins, as in the reference."""
    d, v = 16, 1024
    h = np.ones((2, d), np.float32)
    w = np.zeros((d, v), np.float32)
    w[:, [255, 256, 700]] = 1.0        # row 0: tie across column 256
    want = exit_head_ref(jnp.asarray(h), jnp.ones(d), jnp.asarray(w))
    got = exit_head(torch.from_numpy(h), torch.ones(d), torch.from_numpy(w))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].tolist() == [255, 255]
    w2 = np.zeros((d, v), np.float32)
    w2[:, [127, 128, 384]] = 1.0       # tie across column 128 (float32)
    got2 = exit_head(torch.from_numpy(h), torch.ones(d), torch.from_numpy(w2))
    want2 = exit_head_ref(jnp.asarray(h), jnp.ones(d), jnp.asarray(w2))
    assert got2[0].tolist() == [127, 127] == np.asarray(want2[0]).tolist()
    np.testing.assert_allclose(got2[2].numpy(), np.asarray(want2[2]),
                               rtol=1e-6)


def _split_logits(h, g, w, eps=1e-6):
    """The tensor-core exit head's arithmetic, emulated: the float32 normed
    rows split into hi = bf16(x) and lo = bf16(x - hi), each multiplied by
    the bf16 W exactly (float64 here) and summed; also the single-rounding
    logits bf16(x) @ W."""
    hf = h.to(torch.float32)
    x = hf * torch.rsqrt((hf * hf).mean(-1, keepdim=True) + eps) * g.float()
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    w64 = w.double()
    return hi.double() @ w64 + lo.double() @ w64, hi.double() @ w64


def test_exit_head_hi_lo_split_holds_the_float32_reference():
    """At Qwen3-8B's width (D = 4096) over a V = 8192 slice, with bf16 h, g
    and W, the hi/lo split's max and lse stay within the float32 tolerance
    (2e-3) of the reference's float32 exit head and its argmax is the
    same; a single bf16 rounding of the rows errs far more."""
    rng = np.random.default_rng(4096)
    t, d, v = 8, 4096, 8192
    h = rng.normal(size=(t, d)).astype(np.float32) * 3.0
    g = (rng.normal(size=d) * 0.2 + 1.0).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    (h_j, h_t), (g_j, g_t), (w_j, w_t) = (_both(a, "bfloat16")
                                          for a in (h, g, w))
    ridx, rmx, rlse = (np.asarray(a) for a in exit_head_ref(h_j, g_j, w_j))
    split, single = _split_logits(h_t, g_t, w_t)
    mx = split.max(-1).values.numpy()
    lse = torch.logsumexp(split, -1).numpy()
    np.testing.assert_allclose(mx, rmx, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse, rlse, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(split.argmax(-1).numpy(), ridx)
    full = exit_head_logits(h_t, g_t, w_t).double()
    split_err = float((split - full).abs().max())
    single_err = float((single - full).abs().max())
    assert split_err < 1e-4 < single_err


def test_confidence_is_a_probability():
    rng = np.random.default_rng(7)
    (_, h), (_, g), (_, w) = _head_inputs(rng, 8, 64, 512, "float32")
    _, mx, lse = exit_head(h, g, w)
    conf = confidence_from(mx, lse).numpy()
    assert np.all(conf > 0) and np.all(conf <= 1 + 1e-6)


# ---------------------------------------------------------------------------
# wrappers: the CPU path is the plain version; other devices raise
# ---------------------------------------------------------------------------


def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(0)
    reset_launch_counts()
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    g = torch.ones(32)
    assert torch.equal(rmsnorm(x, g), rmsnorm_plain(x, g))
    q = x.reshape(1, 2, 4, 16)
    assert torch.equal(flash_attention(q, q, q),
                       flash_attention_plain(q, q, q))
    w = torch.from_numpy(rng.normal(size=(32, 300)).astype(np.float32))
    for a, b in zip(exit_head(x, g, w), exit_head_plain(x, g, w)):
        assert torch.equal(a, b)
    assert sum(launch_counts.values()) == 0


@pytest.mark.parametrize("call", [
    lambda t: rmsnorm(t, t[0]),
    lambda t: flash_attention(t[None, None], t[None, None], t[None, None]),
    lambda t: exit_head(t, t[0], t),
])
def test_wrappers_refuse_other_devices(call):
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        call(torch.zeros((4, 4), device="meta"))
