"""The benchmark's window arithmetic against the port's
``summarize_arrays`` with no warm-up dropped, and its own rules for
failed requests."""

from __future__ import annotations

import numpy as np
import pytest

from harness import summary
from repro_torch.core.metrics import summarize_arrays
from repro_torch.core.profile import ProfileTable


@pytest.mark.parametrize("seed", range(4))
def test_matches_summarize_arrays(seed):
    rng = np.random.default_rng(seed)
    n = 500
    lat = rng.gamma(4.0, 0.012, n)
    queue = lat * rng.uniform(0.2, 0.8, n)
    models = rng.integers(0, 2, n)
    exits = rng.integers(0, 4, n)
    batches = rng.integers(1, 9, n)
    taus = np.full(n, 0.05)
    table = ProfileTable(("a", "b"), tuple(f"e{i}" for i in range(4)),
                         (1, 8), np.full((2, 4, 2), 0.01),
                         np.full((2, 4), 0.5))
    want = summarize_arrays(models, exits, batches, lat, queue, taus, table,
                            warmup_tasks=0, span=10.0)
    got = summary.summarize(n, lat, queue, exits, batches, taus, 10.0)
    assert got["p95_ms"] == pytest.approx(1e3 * want.p95_latency, rel=1e-12)
    assert got["p50_ms"] == pytest.approx(1e3 * want.p50_latency, rel=1e-12)
    assert got["mean_exit_depth"] == pytest.approx(want.mean_exit_depth)
    assert got["mean_queue_ms"] == pytest.approx(1e3 * want.mean_queueing)
    met = (1.0 - want.violation_ratio) * want.num_completed
    assert got["goodput_req_s"] == pytest.approx(met / 10.0)
    rows = summary.per_model(models, lat, exits, taus, [
        int((models == 0).sum()), int((models == 1).sum())], 10.0)
    for row, pm in zip(rows, want.per_model):
        assert row["p95_ms"] == pytest.approx(1e3 * pm.p95_latency)
        assert row["mean_exit_depth"] == pytest.approx(pm.mean_exit_depth)


def test_unfinished_requests_fail():
    got = summary.summarize(10, [0.01, 0.02, 0.09], [0.0] * 3, [3, 3, 0],
                            [1, 1, 1], [0.05] * 3, 2.0)
    assert got["failed"] == 7 and got["met_deadline"] == 2
    assert got["goodput_req_s"] == 1.0
    assert got["violation_ratio"] == pytest.approx(0.8)

