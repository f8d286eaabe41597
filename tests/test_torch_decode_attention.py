"""The port's decode-attention wrapper against the JAX reference on the CPU.

Given CPU tensors the wrapper runs its plain version; it is held against
the reference's Pallas kernel in interpret mode and its jnp oracle at the
shapes of ``tests/test_kernels.py``, and against the oracle alone where the
Pallas kernel refuses the shape (S not a multiple of the block). Inputs are
made with numpy from a seed and fed to both sides. The CUDA kernel against
this plain version: ``tests/test_torch_lm_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention.ops import decode_attention as ref_decode
from repro.kernels.decode_attention.ref import decode_attention_ref

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.ops import (
    MAX_CLUSTER,
    MIN_CHUNK,
    TILE,
    decode_attention,
    split,
)

torch.set_num_threads(1)

# tests/test_kernels.py:22-23
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, h, kh, s, d, dtype="float32", lengths=None):
    """(JAX arrays, torch tensors) of the same seeded q, k, v, lengths;
    lengths drawn in [1, S] unless given."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, h, d), (b, kh, s, d), (b, kh, s, d))]
    if lengths is None:
        lengths = rng.integers(1, s + 1, b)
    lens = np.asarray(lengths, np.int32)
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays] + [jnp.asarray(lens)],
            [torch.from_numpy(a).to(tdt) for a in arrays]
            + [torch.from_numpy(lens)])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kh,s,d,bs", [
    (2, 4, 2, 256, 64, 64),
    (1, 8, 4, 512, 128, 128),
    (3, 2, 1, 128, 32, 128),
    (1, 16, 2, 1024, 64, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_and_oracle(b, h, kh, s, d, bs, dtype):
    (jq, jk, jv, jl), (q, k, v, lens) = _inputs(s + d, b, h, kh, s, d, dtype)
    reset_launch_counts()
    got = decode_attention(q, k, v, lens)
    assert got.dtype == q.dtype and got.shape == (b, h, d)
    assert launch_counts["decode_attention"] == 0  # the CPU runs no kernel
    pallas = ref_decode(jq, jk, jv, jl, block_s=bs, interpret=True)
    oracle = decode_attention_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("s", [77, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_s_matches_oracle(s, dtype):
    """S not a multiple of any block: the Pallas kernel asserts, the port
    takes it."""
    (jq, jk, jv, jl), (q, k, v, lens) = _inputs(s, 3, 9, 3, s, 64, dtype)
    np.testing.assert_allclose(
        _f32(decode_attention(q, k, v, lens)),
        _f32(decode_attention_ref(jq, jk, jv, jl)), **TOL[dtype])


def test_length_one_returns_first_value():
    _, (q, k, v, _) = _inputs(4, 2, 6, 2, 64, 32)
    got = decode_attention(q, k, v, torch.tensor([1, 1], dtype=torch.int32))
    want = v[:, :, 0].repeat_interleave(3, dim=1)  # head h reads kv head h//3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cache_tail_is_ignored():
    """Garbage past ``lengths`` does not change the result."""
    _, (q, k, v, _) = _inputs(5, 1, 2, 2, 128, 32)
    lens = torch.tensor([40], dtype=torch.int32)
    out1 = decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] = 1e4
    v2[:, :, 40:] = -1e4
    out2 = decode_attention(q, k2, v2, lens)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5)


def test_lengths_past_s_attend_over_all_of_it():
    (jq, jk, jv, _), (q, k, v, _) = _inputs(6, 2, 4, 2, 50, 16)
    over = torch.tensor([51, 400], dtype=torch.int32)
    full = torch.tensor([50, 50], dtype=torch.int32)
    got = decode_attention(q, k, v, over)
    np.testing.assert_allclose(got.numpy(),
                               decode_attention(q, k, v, full).numpy())
    np.testing.assert_allclose(
        got.numpy(), _f32(decode_attention_ref(jq, jk, jv,
                                               jnp.asarray(over.numpy()))),
        **TOL["float32"])


def test_length_zero_follows_the_oracle():
    """At length 0 every position is masked: the plain version, like the
    reference's oracle, gives the mean of v (the CUDA and Pallas kernels
    give 0; the model never passes 0)."""
    (jq, jk, jv, _), (q, k, v, _) = _inputs(7, 1, 2, 1, 16, 16)
    zero = torch.zeros(1, dtype=torch.int32)
    got = decode_attention(q, k, v, zero)
    np.testing.assert_allclose(
        got.numpy(), _f32(decode_attention_ref(jq, jk, jv,
                                               jnp.zeros(1, jnp.int32))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(), v[0, 0].mean(0).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_takes_the_models_strided_views():
    """q as ``[B, 1, H, D][:, 0]`` and k, v as ``[B, Smax, K, D]``
    transposed, as the model's cache branch passes them."""
    _, (q, k, v, lens) = _inputs(8, 2, 8, 2, 40, 64)
    q_act = q[:, None].contiguous()
    k_cache = k.transpose(1, 2).contiguous()
    v_cache = v.transpose(1, 2).contiguous()
    got = decode_attention(q_act[:, 0], k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), lens)
    np.testing.assert_allclose(got.numpy(),
                               decode_attention(q, k, v, lens).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case,match", [
    ("bad_d", "head dim"),
    ("h_not_multiple", "multiple"),
    ("v_shape", "v has shape"),
    ("k_batch", "k has shape"),
    ("lengths_dtype", "lengths must be int32"),
    ("lengths_shape", "lengths must be int32"),
    ("q_rank", "q must be"),
])
def test_wrapper_refuses_bad_arguments(case, match):
    b, h, kh, s, d = 2, 4, 2, 16, 32
    q, k, v = torch.zeros(b, h, d), torch.zeros(b, kh, s, d), torch.zeros(
        b, kh, s, d)
    lens = torch.ones(b, dtype=torch.int32)
    if case == "bad_d":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif case == "h_not_multiple":
        q = torch.zeros(b, 3, d)
    elif case == "v_shape":
        v = torch.zeros(b, kh, s + 1, d)
    elif case == "k_batch":
        k = torch.zeros(b + 1, kh, s, d)
    elif case == "lengths_dtype":
        lens = lens.long()
    elif case == "lengths_shape":
        lens = torch.ones(b + 1, dtype=torch.int32)
    else:
        q = q[:, None]
    with pytest.raises(ValueError, match=match):
        decode_attention(q, k, v, lens)


def test_wrapper_refuses_other_devices():
    t = torch.zeros((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        decode_attention(t[:, :, 0], t, t,
                         torch.ones(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("b,h,kh", [(1, 32, 8), (8, 32, 8), (1, 9, 3),
                                    (8, 24, 8), (2, 16, 2)])
@pytest.mark.parametrize("s", [0, 1, 77, 160, 1000, 4096, 40000])
def test_split_covers_the_cache_in_bounded_chunks(b, h, kh, s):
    """The launch plan's chunks: whole tiles of TILE positions, one cluster
    of at most MAX_CLUSTER of them (the kernel's limits), covering S with
    no chunk wholly past it; a cache of at most MIN_CHUNK positions is one
    chunk."""
    chunk, n = split(b, kh, s)
    assert chunk % TILE == 0 and chunk >= TILE
    assert 1 <= n <= MAX_CLUSTER and chunk * n >= s
    assert s == 0 or chunk * (n - 1) < s
    if s <= MIN_CHUNK:
        assert n == 1


def _kernel_positions(chunk, n_chunks, length, per_warp, warps):
    """The cache positions each block of the launch reads, as the kernels
    cut them: block c takes [c * chunk, min((c + 1) * chunk, length)), and
    its warps take slices of ``per_warp`` positions round-robin (the
    tensor-core kernel's 8 warps of 16-position slices; the CUDA-core
    kernel's block walks 32-position tiles with all its warps, ``warps=1``)."""
    seen = []
    for c in range(n_chunks):
        n = max(0, min(chunk, length - c * chunk))
        slices = -(-n // per_warp)
        for w in range(warps):
            for s in range(w, slices, warps):
                lo = c * chunk + s * per_warp
                seen.extend(range(lo, min(lo + per_warp, c * chunk + n)))
    return seen


@pytest.mark.parametrize("b,h,kh", [(1, 32, 8), (8, 32, 8), (1, 9, 3),
                                    (8, 24, 8), (2, 16, 2)])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 160, 1000, 4096])
def test_launch_plan_reads_every_valid_position_once(b, h, kh, s):
    """One launch per call: the plan is one grid whose chunks of a (row, kv
    head) fit one cluster; at lengths 0, 1, S / 2, S and past S (clamped)
    every valid position is read exactly once and none past the length."""
    chunk, n_chunks = split(b, kh, s)
    assert n_chunks <= MAX_CLUSTER
    for length in (0, 1, s // 2, s, s + 7):
        valid = min(length, s)
        for per_warp, warps in ((16, 8), (TILE, 1)):
            seen = _kernel_positions(chunk, n_chunks, valid, per_warp, warps)
            assert sorted(seen) == list(range(valid))
