"""The compiled scan tiers on the card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scan_cuda.py

Every test needs a card and skips without one. On the card each chunk of
scan steps is a replayed CUDA graph: a replayed block must leave the carry
and write the outputs of the same block run op by op, bitwise; whole runs
with every block run eagerly must equal the graphed runs; the card's lanes
must equal the CPU's (same decisions, so the same metrics); and a graph
that cannot be captured raises instead of falling back.
"""

import pytest
import torch

from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    make_fleet,
    make_scheduler,
    paper_rate_vector,
    poisson_arrivals,
    simulate_cluster_scan_batch,
    simulate_scan_batch,
)
from repro_torch.core import simfast


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan's graphs run only there")
    return torch.device("cuda")


def _lanes(lam, horizon, seeds):
    return [poisson_arrivals(paper_rate_vector(lam), horizon, seed=s)
            for s in seeds]


@pytest.mark.cuda
@pytest.mark.parametrize("factored", [True, False])
def test_graph_replay_equals_the_eager_block(card, factored):
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler("edgeserving-lattice", table, SchedulerConfig())
    plan = simfast._plan_scan(sched, table, _lanes(140.0, 2.0, range(4)),
                              2.0, None, None, 600.0, factored,
                              emit_aux=True)
    key = plan.key(plan.first_window(None))
    eager = simfast._ScanSteps(key, 4, card)
    graphed = simfast._ScanSteps(key, 4, card)
    plan.load(eager)
    plan.load(graphed)
    for _ in range(4):
        want = eager.eager()
        got = graphed.advance()
        assert graphed.graph is not None
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for g, w in zip(graphed.carry, eager.carry):
            assert torch.equal(g, w)
    assert bool((want[0] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dispatcher", ["stability-aware", "jsq"])
def test_cluster_graph_replay_equals_the_eager_block(card, dispatcher):
    from repro_torch.core import clusterfast

    table = ProfileTable.paper_rtx3080()
    plan = clusterfast._plan_cluster(
        make_fleet("heterogeneous", 4, table), _lanes(400.0, 1.0, range(3)),
        1.0, "edgeserving", SchedulerConfig(), dispatcher, 4, None, 600.0,
        None, 0.0, None)
    key = plan.key(plan.first_window(None))
    eager = clusterfast._ClusterSteps(key, 3, card)
    graphed = clusterfast._ClusterSteps(key, 3, card)
    plan.load(eager)
    plan.load(graphed)
    for _ in range(4):
        want = eager.eager()
        got = graphed.advance()
        assert graphed.graph is not None
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for g, w in zip(graphed.carry, eager.carry):
            assert torch.equal(g, w)
    assert bool((want[0] >= 2).any())     # a round dispatched


def _all_eager(monkeypatch):
    monkeypatch.setattr(simfast._GraphedSteps, "advance",
                        simfast._GraphedSteps.eager)
    simfast._scan_steps.cache_clear()


@pytest.mark.cuda
def test_eager_runs_equal_graphed_runs(card, monkeypatch):
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler("edgeserving", table, SchedulerConfig())
    lanes = _lanes(180.0, 1.5, range(3))
    fleet = make_fleet("heterogeneous", 3, table, fail_at=((1, 0.7),))
    graphed = simulate_scan_batch(sched, table, lanes, 1.5,
                                  keep_traces=True)
    graphed_fleet = simulate_cluster_scan_batch(fleet, lanes, 1.5,
                                                dispatcher="least-loaded")
    _all_eager(monkeypatch)
    eager = simulate_scan_batch(sched, table, lanes, 1.5, keep_traces=True)
    eager_fleet = simulate_cluster_scan_batch(fleet, lanes, 1.5,
                                              dispatcher="least-loaded")
    for g, e in zip(graphed, eager):
        assert g.metrics == e.metrics
        assert [(t.t_start, t.decision.stability_score) for t in g.traces] \
            == [(t.t_start, t.decision.stability_score) for t in e.traces]
    for g, e in zip(graphed_fleet, eager_fleet):
        assert g.metrics == e.metrics
        assert g.completions == e.completions


@pytest.mark.cuda
@pytest.mark.parametrize("dispatcher", ["stability-aware", "jsq"])
def test_card_lanes_equal_cpu_lanes(card, dispatcher):
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler("edgeserving", table, SchedulerConfig())
    lanes = _lanes(140.0, 2.0, range(6))
    on_card = simulate_scan_batch(sched, table, lanes, 2.0)
    on_cpu = simulate_scan_batch(sched, table, lanes, 2.0, device="cpu")
    assert [r.metrics for r in on_card] == [r.metrics for r in on_cpu]
    fleet = make_fleet("heterogeneous", 4, table)
    kw = dict(dispatcher=dispatcher, power_d=4, keep_completions=False)
    f_card = simulate_cluster_scan_batch(fleet, lanes, 2.0, **kw)
    f_cpu = simulate_cluster_scan_batch(fleet, lanes, 2.0, device="cpu",
                                        **kw)
    assert [r.metrics for r in f_card] == [r.metrics for r in f_cpu]


@pytest.mark.cuda
def test_a_capture_that_fails_raises(card, monkeypatch):
    """A host synchronisation inside the step cannot be captured: the call
    raises, it does not run the block eagerly instead."""
    step = simfast._ScanSteps._step

    def syncing(self, row):
        step(self, row)
        bool(self.done.any())       # a host read: illegal while capturing

    monkeypatch.setattr(simfast._ScanSteps, "_step", syncing)
    simfast._scan_steps.cache_clear()
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler("edgeserving", table, SchedulerConfig())
    try:
        with pytest.raises(RuntimeError):
            simulate_scan_batch(sched, table, _lanes(60.0, 0.5, [0]), 0.5)
    finally:
        simfast._scan_steps.cache_clear()
        torch.cuda.synchronize()
