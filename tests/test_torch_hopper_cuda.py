"""The redesigned stability-score and RMSNorm kernels on the card: every
layout each C entry picks from the shape and the addresses, against the
plain versions, and two calls repeating bitwise; the ``cuda`` scoring
backend's round over regrown buffers.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hopper_cuda.py

Every test needs a card and skips without one. RMSNorm is held at the
tolerances of ``tests/test_kernels.py:22-23``, the stability score at
``chip_smoke.py``'s (rtol 1e-5, atol 1e-4).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.scoring import CudaScoringBackend, NumpyScoringBackend
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_pair
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
from repro_torch.kernels.stability_score.ops import stability_scores
from repro_torch.kernels.stability_score.ref import stability_scores_plain

TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _norm_inputs(card, t, d, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((t, d), generator=gen, device=card) * 3
    g = torch.randn((d,), generator=gen, device=card) * 0.2 + 1
    return x.to(dtype), g.to(dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# bf16 D = 100 is not a multiple of 8: the scalar kernels (float32 takes it
# as 25 vectors); D = 128 a sub-warp a row, 576 a warp a row (bf16) or a
# block (float32), 3072 and 4096 a block a row.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 128, 576, 3072, 4096])
@pytest.mark.parametrize("t", [1, 2, 8, 33, 1024, 32768])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_layouts_match_plain(card, t, d, dtype):
    x, g = _norm_inputs(card, t, d, dtype, t + d)
    reset_launch_counts()
    got = rmsnorm(x, g)
    torch.cuda.synchronize()
    assert launch_counts["rmsnorm"] == 1 and got.dtype == dtype
    _close(got, rmsnorm_plain(x, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 4096])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_misaligned_view_takes_the_scalar_path(card, d, dtype):
    """A contiguous [T, D] view one element past a 16-byte boundary."""
    x, g = _norm_inputs(card, 9, d, dtype, d)
    flat = torch.empty(9 * d + 1, dtype=dtype, device=card)
    view = flat[1:].view(9, d)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    _close(rmsnorm(view, g), rmsnorm_plain(x, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,d", [(32, 8, 128), (256, 64, 128),
                                     (32768, 8192, 128), (7, 3, 64),
                                     (5, 2, 100), (3, 1, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_pair_matches_two_plain_calls(card, tq, tk, d, dtype):
    xq, gq = _norm_inputs(card, tq, d, dtype, tq)
    xk, gk = _norm_inputs(card, tk, d, dtype, tk + 1)
    reset_launch_counts()
    oq, ok = rmsnorm_pair(xq, gq, xk, gk)
    torch.cuda.synchronize()
    assert launch_counts["rmsnorm"] == 1
    _close(oq, rmsnorm_plain(xq, gq), dtype)
    _close(ok, rmsnorm_plain(xk, gk), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(1, 4096), (1024, 576), (32768, 128),
                                 (33, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_repeats_bitwise(card, t, d, dtype):
    x, g = _norm_inputs(card, t, d, dtype, 3)
    assert torch.equal(rmsnorm(x, g), rmsnorm(x, g))
    a = rmsnorm_pair(x, g, x[:5], g)
    b = rmsnorm_pair(x, g, x[:5], g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _score_inputs(seed, m, q, n, het):
    rng = np.random.default_rng(seed)
    w = np.sort(rng.uniform(0, 0.2, (m, q)))[:, ::-1].astype(np.float32)
    mask = (rng.uniform(size=(m, q)) > 0.25).astype(np.float32)
    n_c = m if n is None else n
    lat = rng.uniform(1e-3, 3e-2, n_c).astype(np.float32)
    bat = rng.integers(1, min(q, 10) + 1, n_c).astype(np.int32)
    queue = None if n is None else rng.integers(0, m, n).astype(np.int32)
    tau = rng.uniform(0.02, 0.09, (m, q)).astype(np.float32) if het else 0.05
    return w, mask, lat, bat, queue, tau


def _scores(args, device, clip=10.0):
    w, mask, lat, bat, queue, tau = args
    t = (lambda a: torch.from_numpy(a).to(device))
    return stability_scores(
        t(w), t(mask), t(lat), t(bat), None if queue is None else t(queue),
        tau=t(tau) if isinstance(tau, np.ndarray) else tau, clip=clip)


# one warp a candidate up to 4096 tasks (the last at the edge); above, K = 1,
# 2, 4 and 8 candidates a block, with N ragged against K
@pytest.mark.cuda
@pytest.mark.parametrize("m,q,n", [(3, 1, None), (3, 64, None), (3, 7, 12),
                                   (16, 256, 300), (16, 257, 9),
                                   (64, 96, 37), (17, 257, 301),
                                   (40, 128, 603), (256, 128, 1024),
                                   (256, 128, 1021)])
@pytest.mark.parametrize("het", [False, True])
def test_stability_layouts_match_plain(card, m, q, n, het):
    args = _score_inputs(m * 7 + q, m, q, n, het)
    reset_launch_counts()
    got = _scores(args, card)
    torch.cuda.synchronize()
    assert launch_counts["stability_score"] == 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               _scores(args, "cpu").numpy(), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(got, _scores(args, card))


@pytest.mark.cuda
def test_stability_batches_past_q_remove_the_whole_row(card):
    """B_n > Q removes the whole row (the reference's pos < B over Q
    positions); the plain version agrees."""
    w, mask, lat, _, queue, tau = _score_inputs(4, 4, 6, 5, False)
    bat = np.array([1, 6, 9, 30, 0], np.int32)
    args = (w, mask, lat, bat, queue, tau)
    np.testing.assert_allclose(_scores(args, card).cpu().numpy(),
                               _scores(args, "cpu").numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("per_task", [False, True])
def test_backend_round_repeats_bitwise_over_regrown_buffers(card, per_task):
    rounds = [(3, 4, 3), (3, 9, 12), (256, 128, 1024), (2, 1, 2),
              (40, 64, 300), (3, 30, 30)]
    rng = np.random.default_rng(7)
    inputs = []
    for m, q, n in rounds:
        w, mask, lat, bat, _, tau = _score_inputs(int(rng.integers(1 << 30)),
                                                  m, q, n, per_task)
        queue = rng.integers(0, m, n)
        inputs.append((w.astype(np.float64), mask.astype(np.float64),
                       lat.astype(np.float64), bat.astype(np.int64), queue,
                       tau.astype(np.float64) if per_task else tau))
    a, b = CudaScoringBackend(card), CudaScoringBackend(card)
    f64 = NumpyScoringBackend()
    reset_launch_counts()
    first = [a.score(*args) for args in inputs]
    again = [a.score(*args) for args in inputs]        # reused buffers
    fresh = [b.score(*args) for args in inputs[::-1]][::-1]
    assert launch_counts["stability_score"] == 3 * len(rounds)
    for got, rep, other, args in zip(first, again, fresh, inputs):
        np.testing.assert_array_equal(got, rep)
        np.testing.assert_array_equal(got, other)
        want = f64.score(*args)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        i, j = int(np.argmin(got)), int(np.argmin(want))
        assert i == j or abs(want[i] - want[j]) <= 1e-6 * abs(want[j])
