"""The benchmark's generator (``harness/traffic.py``) as a Poisson process
conditioned on its count: the same count per model for every seed, and
times that are uniform on the horizon, with exponential gaps."""

from __future__ import annotations

import numpy as np
import pytest

from harness import traffic

SEEDS = (0, 7, 2 ** 31 + 11, 2900000001)
MIX = {"process": "poisson", "load": 0.8}
HORIZON = 10.0


def _times(seed, first_id=0):
    rates = traffic.model_rates(MIX, 300.0, [2, 1])
    reqs = traffic.arrivals(MIX, rates, HORIZON, seed, first_id=first_id)
    return rates, reqs


@pytest.mark.parametrize("seed", SEEDS)
def test_count_is_fixed_for_every_seed(seed):
    rates, reqs = _times(seed, first_id=5)
    assert rates == pytest.approx([160.0, 80.0])
    times = np.array([r.arrival for r in reqs])
    assert np.all(np.diff(times) >= 0) and 0 <= times[0] and \
        times[-1] < HORIZON
    assert [r.req_id for r in reqs] == list(range(5, 5 + len(reqs)))
    assert tuple(np.bincount([r.model for r in reqs])) == (1600, 800)
    assert all(0 <= r.data_id < 10_000 for r in reqs)


@pytest.mark.parametrize("seed", SEEDS)
def test_times_are_uniform(seed):
    """Kolmogorov-Smirnov against the uniform law, per model, at the 0.1%
    level (1.95 / sqrt(n))."""
    _, reqs = _times(seed)
    for m in (0, 1):
        t = np.sort([r.arrival for r in reqs if r.model == m]) / HORIZON
        n = len(t)
        d = max(np.max(np.arange(1, n + 1) / n - t),
                np.max(t - np.arange(n) / n))
        assert d < 1.95 / np.sqrt(n), (m, d)


@pytest.mark.parametrize("seed", SEEDS)
def test_gaps_are_exponential(seed):
    """The gaps between one model's arrivals have the exponential law's
    mean, spread (coefficient of variation 1) and tail (P(gap > mean) =
    1/e), within a few standard errors."""
    rates, reqs = _times(seed)
    for m, lam in enumerate(rates):
        gaps = np.diff(np.sort([r.arrival for r in reqs if r.model == m]))
        n = len(gaps)
        assert gaps.mean() == pytest.approx(1.0 / lam, rel=4 / np.sqrt(n))
        assert gaps.std() / gaps.mean() == pytest.approx(1.0,
                                                         abs=5 / np.sqrt(n))
        tail = np.mean(gaps > gaps.mean())
        assert tail == pytest.approx(np.exp(-1.0), abs=4 * 0.5 / np.sqrt(n))


def test_seeds_change_when_not_how_many():
    a = [r.arrival for r in _times(1)[1]]
    b = [r.arrival for r in _times(2)[1]]
    assert len(a) == len(b) and a != b
    assert [r.arrival for r in _times(1)[1]] == a


def test_unknown_process_is_refused():
    with pytest.raises(ValueError):
        traffic.events({"process": "mmpp", "load": 1.0}, [1.0], 1.0, 0)
