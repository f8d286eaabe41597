"""The stability-score kernel's plain version against the reference's
Pallas kernel (interpret mode) and its jnp oracle, at the tolerances of
``tests/test_kernels.py``; and the CUDA kernel against the plain version
where a card is present."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.stability_score.ops import stability_scores as ref_kernel
from repro.kernels.stability_score.ref import (
    lattice_stability_scores_ref as ref_lattice,
)

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.stability_score import ops
from repro_torch.kernels.stability_score.ref import stability_scores_plain


def _inputs(seed, m, q, n=None, het=False):
    rng = np.random.default_rng(seed)
    w = np.sort(rng.uniform(0, 0.2, (m, q)))[:, ::-1].astype(np.float32)
    mask = (rng.uniform(size=(m, q)) > 0.25).astype(np.float32)
    n_c = m if n is None else n
    lat = rng.uniform(1e-3, 3e-2, n_c)               # float64, as the host has
    bat = rng.integers(1, q + 1, n_c).astype(np.int32)
    queue = None if n is None else rng.integers(0, m, n).astype(np.int32)
    tau = rng.uniform(0.02, 0.09, (m, q)).astype(np.float32) if het else 0.05
    return w, mask, lat, bat, queue, tau


def _port(w, mask, lat, bat, queue, tau, clip, device="cpu"):
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return ops.stability_scores(
        t(w), t(mask), t(lat), t(bat), None if queue is None else t(queue),
        tau=t(tau) if isinstance(tau, np.ndarray) else tau, clip=clip)


def _ref(w, mask, lat, bat, queue, tau, clip):
    return np.asarray(ref_kernel(
        jnp.asarray(w), jnp.asarray(mask), jnp.asarray(lat, jnp.float32),
        jnp.asarray(bat), None if queue is None else jnp.asarray(queue),
        tau=jnp.asarray(tau) if isinstance(tau, np.ndarray) else tau,
        clip=clip, interpret=True))


@pytest.mark.parametrize("m,q", [(3, 16), (8, 64), (5, 33), (16, 128),
                                 (3, 1)])
@pytest.mark.parametrize("het", [False, True])
def test_greedy_layout_matches_pallas_interpret(m, q, het):
    args = _inputs(m * 100 + q, m, q, het=het)
    out = _port(*args, clip=10.0)
    assert out.dtype == torch.float32 and out.shape == (m,)
    np.testing.assert_allclose(out.numpy(), _ref(*args, clip=10.0), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 12, 13, 37])
@pytest.mark.parametrize("clip", [10.0, 3.0])
@pytest.mark.parametrize("het", [False, True])
def test_lattice_layout_matches_pallas_interpret(n, clip, het):
    """N not a multiple of the Pallas block (8), explicit cand_queue."""
    args = _inputs(n, 4, 24, n=n, het=het)
    out = _port(*args, clip=clip)
    np.testing.assert_allclose(out.numpy(), _ref(*args, clip=clip), rtol=1e-5)


@pytest.mark.parametrize("seed", range(15))
def test_property_matches_jnp_oracle(seed):
    rng = np.random.default_rng(seed)
    m, q = int(rng.integers(2, 6)), int(rng.integers(4, 24))
    n = int(rng.integers(1, 20))
    w, mask, lat, bat, queue, tau = _inputs(seed, m, q, n=n,
                                            het=bool(seed % 2))
    clip = float(rng.choice([10.0, 3.0, 1.5]))
    out = _port(w, mask, lat, bat, queue, tau, clip)
    ref = ref_lattice(jnp.asarray(w), jnp.asarray(mask),
                      jnp.asarray(lat, jnp.float32), jnp.asarray(bat),
                      jnp.asarray(queue), jnp.asarray(tau), clip)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4)


def test_plain_version_computes_total_minus_removed():
    w, mask, lat, bat, queue, tau = _inputs(0, 3, 8, n=4)
    t = torch.from_numpy
    got = stability_scores_plain(t(w), t(mask), t(lat), t(bat), t(queue),
                                 tau=tau, clip=10.0).numpy()
    urg = np.minimum(np.exp(np.minimum(
        (w[None] + lat.astype(np.float32)[:, None, None]) / np.float32(tau)
        - 1, np.log(np.float32(10.0)))), 10.0) * mask[None]
    served = np.arange(8)[None] < bat[:, None]
    want = urg.sum((1, 2)) - (urg[np.arange(4), queue] * served).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cpu_tensors_do_not_count_as_launches():
    reset_launch_counts()
    _port(*_inputs(1, 3, 8), clip=10.0)
    assert launch_counts["stability_score"] == 0


def test_wrapper_rejects_other_devices():
    w = torch.zeros((3, 4), device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ops.stability_scores(w, w, torch.zeros(3, device="meta"),
                             torch.zeros(3, device="meta"), tau=0.05)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,q,n", [(3, 1, None), (3, 64, None), (3, 7, 12),
                                   (256, 128, 1024)])
@pytest.mark.parametrize("het", [False, True])
def test_cuda_kernel_matches_plain(card, m, q, n, het):
    args = _inputs(m + q, m, q, n=n, het=het)
    reset_launch_counts()
    got = _port(*args, clip=10.0, device=card)
    torch.cuda.synchronize()
    assert launch_counts["stability_score"] == 1
    want = _port(*args, clip=10.0, device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
