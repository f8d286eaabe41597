"""``repro_torch.core.urgency``'s torch functions compute in ``w``'s dtype.

float32 is the plain version the stability-score kernel is held against:
its outputs must stay bitwise those of the float32-only functions the port
had before (kept below as the frozen reference). float64 is the scan's
direct scoring mode: it must match the reference's jnp function under x64
(same argmin, scores within rtol 1e-12).
"""

import importlib

import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

# the module, not the function ``repro.core`` exports under the same name
ref_urgency = importlib.import_module("repro.core.urgency")
urgency = importlib.import_module("repro_torch.core.urgency")


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _lattice_f32_frozen(w, mask, cand_latency, cand_batch, cand_queue, tau,
                        clip=urgency.DEFAULT_CLIP):
    """The float32-only ``lattice_stability_scores`` as the port had it."""
    max_q = w.shape[1]
    n = cand_latency.shape[0]
    pos = torch.arange(max_q, device=w.device)[None, :]
    served = pos < cand_batch[:, None]
    tau_t = _f32(tau, w)
    tau_b = tau_t[None, :, :] if tau_t.ndim == 2 else tau_t
    clip_t = _f32(clip, w)
    shifted = w[None, :, :] + cand_latency[:, None, None]
    urg = torch.minimum(
        torch.exp(torch.minimum(shifted / tau_b - 1.0, torch.log(clip_t))),
        clip_t,
    ) * mask[None, :, :]
    total = torch.sum(urg, dim=(1, 2))
    own = urg[torch.arange(n, device=w.device), cand_queue.long(), :]
    removed = torch.sum(own * served, dim=1)
    return total - removed


def _urgency_f32_frozen(w, tau, clip=urgency.DEFAULT_CLIP):
    clip_t = _f32(clip, w)
    return torch.minimum(
        torch.exp(torch.minimum(w / _f32(tau, w) - 1.0, torch.log(clip_t))),
        clip_t)


def _case(seed, m=5, q=12, n=40, het=False):
    rng = np.random.default_rng(seed)
    qlen = rng.integers(0, q + 1, m)
    mask = (np.arange(q)[None, :] < qlen[:, None]).astype(np.float64)
    w = np.sort(rng.uniform(0.0, 0.2, (m, q)), axis=1)[:, ::-1] * mask
    lat = rng.uniform(0.002, 0.05, n)
    batch = rng.integers(1, q + 1, n)
    queue = rng.integers(0, m, n)
    tau = rng.uniform(0.03, 0.09, (m, q)) if het else 0.05
    return w.copy(), mask, lat, batch, queue, tau


@pytest.mark.parametrize("het", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_bitwise_as_before(seed, het):
    w, mask, lat, batch, queue, tau = _case(seed, het=het)
    args = [torch.tensor(w, dtype=torch.float32),
            torch.tensor(mask, dtype=torch.float32),
            torch.tensor(lat, dtype=torch.float32),
            torch.tensor(batch), torch.tensor(queue)]
    tau_arg = torch.tensor(tau, dtype=torch.float32) if het else tau
    got = urgency.lattice_stability_scores(*args, tau_arg, clip=7.0)
    want = _lattice_f32_frozen(*args, tau_arg, clip=7.0)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(urgency.urgency(args[0], tau_arg),
                       _urgency_f32_frozen(args[0], tau_arg))
    got_c = urgency.candidate_stability_scores(
        args[0], args[1], args[2][:5], args[3][:5], tau_arg)
    want_c = _lattice_f32_frozen(args[0], args[1], args[2][:5], args[3][:5],
                                 torch.arange(5), tau_arg)
    assert torch.equal(got_c, want_c)


@pytest.mark.parametrize("het", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_float64_matches_the_reference_under_x64(seed, het):
    w, mask, lat, batch, queue, tau = _case(seed, het=het)
    got = urgency.lattice_stability_scores(
        torch.tensor(w), torch.tensor(mask), torch.tensor(lat),
        torch.tensor(batch), torch.tensor(queue),
        torch.tensor(tau) if het else tau)
    assert got.dtype == torch.float64
    with enable_x64():
        import jax.numpy as jnp
        want = np.asarray(ref_urgency.lattice_stability_scores(
            jnp.asarray(w), jnp.asarray(mask), jnp.asarray(lat),
            jnp.asarray(batch), jnp.asarray(queue),
            jnp.asarray(tau) if het else tau))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0.0)
    assert int(got.argmin()) == int(np.argmin(want))


def test_lane_axis_equals_one_lane_at_a_time():
    """The scan scores all its lanes in one call: a leading lane axis gives
    each lane's scores bitwise."""
    lanes = [_case(s) for s in range(3)]
    queue = torch.tensor(lanes[0][4])
    tau = torch.full((5, 1), 0.05, dtype=torch.float64)
    stacked = urgency.lattice_stability_scores(
        torch.tensor(np.stack([c[0] for c in lanes])),
        torch.tensor(np.stack([c[1] for c in lanes])),
        torch.tensor(np.stack([c[2] for c in lanes])),
        torch.tensor(np.stack([c[3] for c in lanes])), queue, tau)
    for i, (w, mask, lat, batch, _, _) in enumerate(lanes):
        one = urgency.lattice_stability_scores(
            torch.tensor(w), torch.tensor(mask), torch.tensor(lat),
            torch.tensor(batch), queue, tau)
        assert torch.equal(stacked[i], one)
