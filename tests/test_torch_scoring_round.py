"""The ``cuda`` scoring backend's round on the CPU (``device="cpu"``):
the same packing into its held staging buffer, run through the kernel's
plain version, over a sequence of rounds whose M, Q and N grow and shrink,
so that the buffers are regrown and reused. Its scores must hold the
reference package's float64 ``numpy`` backend (``repro.core.scoring``)
within the kernel's tolerance, and its decisions must equal that backend's
up to float32 ties, with a scalar SLO and with per-task deadlines. The
port's own ``numpy`` backend is a second check."""

import numpy as np
import pytest

from repro.core.scoring import NumpyScoringBackend as RefNumpyBackend
from repro_torch.core.scoring import CudaScoringBackend, NumpyScoringBackend
from repro_torch.kernels import launch_counts, reset_launch_counts

TIE_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-4  # the stability kernel against its plain version

# (M, Q, N): up, down, and up past every earlier size
ROUNDS = [(3, 4, 3), (3, 9, 12), (40, 64, 300), (2, 1, 2), (3, 30, 30),
          (64, 128, 700), (1, 3, 1), (5, 17, 40)]


def _round(rng, m, q, n, per_task):
    w = np.sort(rng.uniform(0, 0.2, (m, q)))[:, ::-1].copy()
    mask = (rng.uniform(size=(m, q)) > 0.2).astype(np.float64)
    lat = rng.uniform(1e-3, 3e-2, n)
    bat = rng.integers(1, min(q, 10) + 1, n)
    queue = rng.integers(0, m, n)
    tau = rng.uniform(0.02, 0.09, (m, q)) if per_task else 0.05
    return w, mask, lat, bat, queue, tau


def _assert_decides_as(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    a, b = int(np.argmin(got)), int(np.argmin(want))
    assert a == b or abs(want[a] - want[b]) <= TIE_RTOL * abs(want[b])


@pytest.mark.parametrize("per_task", [False, True])
def test_rounds_over_regrown_buffers_decide_as_numpy(per_task):
    rng = np.random.default_rng(int(per_task))
    cuda, ref, f64 = (CudaScoringBackend("cpu"), RefNumpyBackend(),
                      NumpyScoringBackend())
    reset_launch_counts()
    grown, held = 0, None
    for m, q, n in ROUNDS:
        args = _round(rng, m, q, n, per_task)
        got = cuda.score(*args, clip=10.0)
        assert got.dtype == np.float32 and got.shape == (n,)
        for backend in (ref, f64):
            _assert_decides_as(got, backend.score(*args, clip=10.0))
        grown += cuda._host is not held
        held = cuda._host
    # grown by doubling: fewer times than rounds, and never shrunk
    assert 1 <= grown < len(ROUNDS)
    assert launch_counts["stability_score"] == 0  # the CPU launches none


def test_a_round_returns_scores_the_next_round_cannot_overwrite():
    rng = np.random.default_rng(5)
    cuda, ref = CudaScoringBackend("cpu"), RefNumpyBackend()
    for per_task in (False, True):
        first_args = _round(rng, 3, 8, 6, per_task)
        first = cuda.score(*first_args)
        kept = first.copy()
        second_args = _round(rng, 3, 8, 6, per_task)
        second = cuda.score(*second_args)
        np.testing.assert_array_equal(first, kept)
        _assert_decides_as(first, ref.score(*first_args))
        _assert_decides_as(second, ref.score(*second_args))


@pytest.mark.parametrize("per_task", [False, True])
def test_pack_lays_out_one_staging_buffer(per_task):
    """float32 w | mask | tau (per-task only) | latency, then int32 batch |
    queue, as the kernel's launch reads them; the scores after them."""
    w, mask, lat, bat, queue, tau = _round(np.random.default_rng(2), 3, 5,
                                           4, per_task)
    cuda = CudaScoringBackend("cpu")
    assert cuda.pack(w, mask, lat, bat, queue, tau) == (3, 5, 4, per_task)
    buf = cuda._host_np
    parts = [w, mask] + ([tau] if per_task else []) + [lat]
    at = 0
    for part in parts:
        flat = np.asarray(part, np.float32).reshape(-1)
        np.testing.assert_array_equal(buf[at:at + flat.size], flat)
        at += flat.size
    ints = buf[at:at + 8].view(np.int32)
    np.testing.assert_array_equal(ints[:4], bat)
    np.testing.assert_array_equal(ints[4:], queue)
    assert cuda._scores_at((3, 5, 4, per_task)) == at + 8
