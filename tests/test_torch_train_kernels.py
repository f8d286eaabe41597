"""The backward of the port's two kernels on the training path, on the CPU:
the plain backwards (``rmsnorm_bwd_plain``, ``flash_attention_bwd_plain``)
and the autograd Functions' CPU path (the plain forward, then the plain
backward), against ``torch.autograd.grad`` of the plain forwards and
against ``jax.vjp`` of the reference's ``rms_norm`` and ``_sdpa``. GQA
groups G in {1, 3, 4}, head dims 16, 64 and 128, causal and not, ragged S.

Tolerances are ``tests/test_kernels.py:22-23``'s (float32 2e-3, bfloat16
3e-2), applied to gradients as max|got - want| <= tol * (1 + max|want|)
(``torch_train``'s rule). The kernels themselves are held against these
plain backwards on the card by ``tests/test_torch_train_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import _sdpa as ref_sdpa
from repro.models.common import rms_norm as ref_rms_norm

from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm.ops import (
    rmsnorm,
    rmsnorm_bwd,
    rmsnorm_pair,
    rmsnorm_pair_bwd,
)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_plain, rmsnorm_plain

from torch_train import assert_grad_close

torch.set_num_threads(1)

TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
ATTN_SHAPES = [  # (B, H, K, S, D, causal)
    (2, 4, 4, 13, 16, True),     # G = 1, ragged S
    (1, 3, 1, 77, 64, True),     # G = 3
    (2, 8, 2, 33, 128, True),    # G = 4
    (2, 4, 1, 20, 64, False),    # non-causal, G = 4
    (1, 6, 2, 9, 16, False),     # non-causal, G = 3
]


def _randn(rng, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    a = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(name, got, want, dtype):
    assert_grad_close(name, _np(got) if torch.is_tensor(got) else got,
                      np.asarray(want, np.float32), TOL[dtype])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _norm_inputs(seed, t, d, dtype):
    rng = np.random.default_rng(seed)
    return (_randn(rng, t, d, scale=3.0, dtype=dtype),
            _randn(rng, d, scale=0.2, shift=1.0, dtype=dtype),
            _randn(rng, t, d, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t, d", [(7, 64), (32, 48), (5, 576)])
def test_rmsnorm_bwd_plain_matches_autograd(t, d, dtype):
    x, g, dy = _norm_inputs(t * d, t, d, dtype)
    xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    want_dx, want_dg = torch.autograd.grad(rmsnorm_plain(xr, gr, 1e-6),
                                           (xr, gr), dy)
    dx, dg = rmsnorm_bwd_plain(x, g, dy, 1e-6)
    assert dx.dtype == dtype and dg.dtype == torch.float32
    _close("dx", dx, _np(want_dx), dtype)
    _close("dgain", dg, _np(want_dg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t, d", [(7, 64), (5, 576)])
def test_rmsnorm_bwd_plain_matches_reference_vjp(t, d, dtype):
    x, g, dy = _norm_inputs(t + d, t, d, dtype)
    jx, jg, jdy = (jnp.asarray(_np(a)).astype(JNP[dtype]) for a in (x, g, dy))
    _, vjp = jax.vjp(lambda a, b: ref_rms_norm(a, b, 1e-6), jx, jg)
    want_dx, want_dg = vjp(jdy)
    dx, dg = rmsnorm_bwd_plain(x, g, dy, 1e-6)
    _close("dx", dx, np.asarray(want_dx.astype(jnp.float32)), dtype)
    _close("dgain", dg, np.asarray(want_dg.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_function_cpu_path_is_the_plain_backward(dtype):
    x, g, dy = _norm_inputs(11, 9, 64, dtype)
    xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    before = dict(launch_counts)
    out = rmsnorm(xr, gr)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), rmsnorm_plain(x, g))
    dx, dg = torch.autograd.grad(out, (xr, gr), dy)
    want_dx, want_dg = rmsnorm_bwd_plain(x, g, dy)
    assert torch.equal(dx, want_dx)
    assert dg.dtype == dtype and torch.equal(dg, want_dg.to(dtype))
    assert torch.equal(torch.stack(rmsnorm_bwd(x, g, dy)[:1]),
                       want_dx[None])
    assert dict(launch_counts) == before


def test_rmsnorm_takes_the_direct_path_without_a_gradient():
    x, g, _ = _norm_inputs(12, 4, 16, torch.float32)
    assert rmsnorm(x, g).grad_fn is None
    xr = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert rmsnorm(xr, g).grad_fn is None
    with torch.inference_mode():
        assert rmsnorm(xr, g).grad_fn is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_pair_function_matches_two_backwards(dtype):
    """Qwen3's q/k norm pair: one Function, each tensor's gradient and its
    own gain's."""
    xq, gq, dyq = _norm_inputs(21, 24, 16, dtype)
    xk, gk, dyk = _norm_inputs(22, 8, 16, dtype)
    leaves = [a.clone().requires_grad_(True) for a in (xq, gq, xk, gk)]
    oq, ok = rmsnorm_pair(*leaves)
    got = torch.autograd.grad((oq, ok), leaves, (dyq, dyk))
    want = (*rmsnorm_bwd_plain(xq, gq, dyq), *rmsnorm_bwd_plain(xk, gk, dyk))
    for name, a, b in zip(("dxq", "dgq", "dxk", "dgk"), got, want):
        assert torch.equal(a, b.to(a.dtype)), name
    for a, b in zip(rmsnorm_pair_bwd(xq, gq, dyq, xk, gk, dyk), want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def _attn_inputs(seed, shape, dtype):
    b, h, kh, s, d, _ = shape
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, h, s, d, dtype=dtype),
            _randn(rng, b, kh, s, d, dtype=dtype),
            _randn(rng, b, kh, s, d, dtype=dtype),
            _randn(rng, b, h, s, d, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_bwd_plain_matches_autograd(shape, dtype):
    causal = shape[-1]
    q, k, v, do = _attn_inputs(sum(shape[:5]), shape, dtype)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd_plain(q, k, v, out.detach(), do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close(name, a, _np(b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_bwd_plain_matches_reference_vjp(shape, dtype):
    """Against ``jax.vjp`` of the reference's ``_sdpa`` in its
    ``[B, S, H, D]`` layout."""
    causal = shape[-1]
    q, k, v, do = _attn_inputs(7 * sum(shape[:5]), shape, dtype)

    def bshd(t):
        return jnp.asarray(_np(t.transpose(1, 2))).astype(JNP[dtype])

    out, vjp = jax.vjp(lambda a, b, c: ref_sdpa(a, b, c, causal),
                       bshd(q), bshd(k), bshd(v))
    want = vjp(bshd(do))
    o = torch.from_numpy(np.array(out.astype(jnp.float32))).to(
        dtype).transpose(1, 2)
    got = flash_attention_bwd_plain(q, k, v, o, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a.transpose(1, 2),
               np.asarray(b.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTN_SHAPES[:3], ids=str)
def test_flash_attention_function_cpu_path(shape, dtype):
    """The Function saves q, k, v and the output, and its backward is the
    plain backward; strided ``[B, H, S, D]`` views of ``[B, S, H, D]``
    activations (the model's way) go in as they are."""
    causal = shape[-1]
    q, k, v, do = _attn_inputs(3 * sum(shape[:5]), shape, dtype)
    leaves = [a.transpose(1, 2).contiguous().requires_grad_(True)
              for a in (q, k, v)]
    views = [a.transpose(1, 2) for a in leaves]
    before = dict(launch_counts)
    out = flash_attention(*views, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want = flash_attention_bwd_plain(q, k, v, out.detach(), do, causal)
    for a, b in zip(got, want):
        assert torch.equal(a.transpose(1, 2), b)
    for a, b in zip(flash_attention_bwd(q, k, v, out.detach(), do,
                                        causal=causal), want):
        assert torch.equal(a, b)
    assert dict(launch_counts) == before


def test_flash_attention_takes_the_direct_path_without_a_gradient():
    q, k, v, _ = _attn_inputs(5, ATTN_SHAPES[0], torch.float32)
    assert flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(q.requires_grad_(True), k, v).grad_fn is None
