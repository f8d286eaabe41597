"""A whole run of a cell on the CPU at the SMOKE sizes (the harness's look
for a card skipped), sound and with the timed path broken underneath:
every fault that a one-chip serving cell can have has to turn ``correct``
false. Also the frozen float64 decision rule against the port's
float64 scheduler."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from harness.cell import run_cell
from reference import stability
from repro_torch.core import SchedulerConfig, make_scheduler
from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot
from smallcfg import BENCH, small_config

WINDOW_S = 0.6


def _traffic():
    return json.loads((BENCH / "traffic" / "steady.json").read_text())


def altered_token(m, e, out):
    """The answer altered where it is produced."""
    tok, mx, lse = out
    return ((tok + 1) % 256).to(tok.dtype), mx, lse


def altered_max(m, e, out):
    """The max logit altered where it is produced (token and logsumexp
    left right)."""
    tok, mx, lse = out
    return tok, mx + 0.05, lse


def half_batch(m, e, out):
    """Half of the batch left out: the rest's answers stand in for it."""
    b = out[0].shape[0]
    keep = torch.arange(b) % max(b // 2, 1)
    return tuple(x[keep] for x in out)


class Stale:
    """A step that returns its state unchanged: the model's previous
    answers come back again."""

    def __init__(self):
        self.prev = {}

    def __call__(self, m, e, out):
        prev = self.prev.get(m)
        self.prev[m] = out
        if prev is None:
            return out
        b = out[0].shape[0]
        idx = torch.arange(b) % prev[0].shape[0]
        return tuple(x[idx] for x in prev)


def _run(fault=None, trace=False):
    # a load that forms batches, so that a half batch can be left out
    config = dict(small_config(), knee_req_s=500.0)
    return run_cell(config, _traffic(), 2 ** 31 + 3, WINDOW_S, trace,
                    torch.device("cpu"), time.perf_counter(), fault=fault)


def test_sound_run_is_correct():
    rec = _run()
    assert rec.correct, rec.checks
    assert rec.summary["completed"] > 0 and rec.sample_rows > 0
    assert rec.summary["mean_batch"] > 1.5


def test_traced_run_reads_the_window():
    """With ``trace`` the window is served as without, its host metrics
    read from it alone, and then a traced stretch; the comparison covers
    both."""
    rec = _run(trace=True)
    assert rec.correct, rec.checks
    assert rec.arrivals == round(0.8 * 500.0 * WINDOW_S)
    assert rec.summary["completed"] <= rec.arrivals
    assert rec.trace is not None and 0 < rec.trace["window_s"] < WINDOW_S
    assert 0 < len(rec.round_seconds) <= rec.summary["completed"]


@pytest.mark.parametrize("trace", (False, True), ids=("window", "traced"))
@pytest.mark.parametrize("fault", [altered_token, altered_max, half_batch,
                                   Stale],
                         ids=["altered_token", "altered_max", "half_batch",
                              "stale_state"])
def test_fault_is_caught(fault, trace):
    fault = fault() if isinstance(fault, type) else fault
    rec = _run(fault, trace)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("seed", range(3))
def test_frozen_decision_rule_is_the_ports(seed):
    rng = np.random.default_rng(seed)
    table = ProfileTable(
        ("a", "b"), tuple(f"e{i}" for i in range(4)), (1, 2, 4, 8),
        np.sort(rng.uniform(0.004, 0.04, (2, 4, 4)), axis=2),
        np.full((2, 4), np.nan))
    port = make_scheduler("edgeserving", table,
                          SchedulerConfig(slo=0.05, max_batch=8))
    for _ in range(200):
        waits = [np.sort(rng.uniform(0, 0.08, rng.integers(0, 12)))[::-1]
                 for _ in range(2)]
        snap = QueueSnapshot(0.0, waits)
        d = port.decide(snap)
        if d is None:
            continue
        pick = (d.model, d.exit_idx, d.batch_size)
        assert not stability.off_choice(waits, table.latency,
                                        table.batch_sizes, 0.05, 8, 10.0,
                                        pick, 1e-12)
        wrong = (d.model, (d.exit_idx + 1) % 4, d.batch_size)
        assert stability.off_choice(waits, table.latency, table.batch_sizes,
                                    0.05, 8, 10.0, wrong, 1e-5)
