"""The live engine's ``profiler=`` and ``tracer=`` hooks against the JAX
reference's engine on the CPU.

Both engines run a stub forward under a step clock (each read advances
1 ms), as ``tests/test_telemetry.py``'s engine tests do, so every quantum
measures the same service time in both and every decision is
deterministic. The port's six counters, its completion log, its live trace
(down to the NDJSON and Chrome-trace bytes) and the table the profiler
leaves the scheduler with must equal the reference's. A refresh swaps the
scheduler's table and counts in ``counters["profiler_refreshes"]``; the
engine does not restore the table when a run ends. With both hooks
``None`` a run is bitwise the stock run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as P
from repro.runtime.server import ServedModel as RefServed
from repro.runtime.server import ServingEngine as RefEngine

from repro_torch.core import (
    AdaptConfig,
    OnlineProfiler,
    ProfileTable,
    SchedulerConfig,
    Tracer,
    export_chrome_trace,
    export_ndjson,
    make_scheduler,
)
from repro_torch.runtime.server import ServedModel, ServingEngine

from torch_compare import plain

ADAPT = dict(refresh_every=0.01, min_samples=1, window=8)


class StepClock:
    """Deterministic clock: each read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _views():
    """Two models, two exits: a table whose ms-scale cells a 1 ms step
    clock under- and over-shoots, so the profiler has drift to learn."""
    pick = lambda t: t.select_models([0, 2]).restrict_exits([0, 3])
    return pick(ProfileTable.paper_rtx3080()), pick(
        R.ProfileTable.paper_rtx3080())


def _engines(policy, profiler, tracer, slo=0.05, safety=False):
    view, ref_view = _views()
    cfg = dict(slo=slo, max_batch=4)
    adapt = dict(ADAPT, safety=safety)
    port = ServingEngine(
        [ServedModel(f"m{m}", None, lambda v, x, e: x.sum(),
                     lambda b: torch.ones((b, 2)), 2) for m in range(2)],
        make_scheduler(policy, view, SchedulerConfig(**cfg)),
        clock=StepClock(),
        profiler=(OnlineProfiler(view, AdaptConfig(**adapt))
                  if profiler else None),
        tracer=Tracer() if tracer else None)
    ref = RefEngine(
        [RefServed(f"m{m}", None, lambda v, x, e: x.sum(),
                   lambda b: jnp.ones((b, 2)), 2) for m in range(2)],
        R.make_scheduler(policy, ref_view, R.SchedulerConfig(**cfg)),
        clock=StepClock(),
        profiler=(R.OnlineProfiler(ref_view, R.AdaptConfig(**adapt))
                  if profiler else None),
        tracer=R.Tracer() if tracer else None)
    return port, ref


def _arrivals(pkg, seed, rates=(180.0, 90.0), horizon=0.3):
    return pkg.poisson_arrivals(list(rates), horizon, seed=seed)


def _serve(engine, arrivals, horizon=0.3):
    log, span = engine.run(arrivals, horizon, idle_sleep=0.0)
    return [dataclasses.astuple(c) for c in log], span


CASES = [
    ("edgeserving", True, True, 0),
    ("edgeserving", True, False, 1),
    ("edgeserving", False, True, 2),
    ("edgeserving-lattice", True, True, 3),
    ("symphony", True, True, 4),
]


@pytest.mark.parametrize("policy,profiler,tracer,seed", CASES)
def test_hooked_engine_equals_the_reference(policy, profiler, tracer, seed,
                                            tmp_path):
    port, ref = _engines(policy, profiler, tracer,
                         slo=0.012 if policy == "symphony" else 0.05)
    got, want = (_serve(port, _arrivals(P, seed)),
                 _serve(ref, _arrivals(R, seed)))
    assert got == want
    assert list(port.counters.items()) == list(ref.counters.items())
    assert len(port.counters) == 6
    assert port.dropped == ref.dropped
    np.testing.assert_array_equal(port.scheduler.table.latency,
                                  ref.scheduler.table.latency)
    if profiler:
        assert port.counters["profiler_refreshes"] > 0
    if not tracer:
        assert port.trace() is None
        return
    trace = port.trace(run="unit", horizon=0.3)
    ref_trace = ref.trace(run="unit", horizon=0.3)
    assert plain(trace) == plain(ref_trace)
    assert trace.meta["engine"] == "live" and trace.meta["run"] == "unit"
    assert len(trace.decisions) == port.counters["batches_served"]
    assert len(trace.spans) == len(got[0]) + port.dropped
    kinds = [e.kind for e in trace.events]
    assert kinds.count("profiler-refresh") == port.counters[
        "profiler_refreshes"]
    assert kinds[-1] == "engine-counters"
    assert trace.events[-1].payload_dict() == port.counters
    if policy == "symphony":
        assert port.dropped > 0 and "shed" in kinds
    for write, ref_write in ((export_ndjson, R.export_ndjson),
                             (export_chrome_trace, R.export_chrome_trace)):
        a, b = tmp_path / "port", tmp_path / "ref"
        write(trace, str(a))
        ref_write(ref_trace, str(b))
        assert a.read_bytes() == b.read_bytes()


def test_a_refresh_swaps_the_table_and_is_not_undone():
    port, _ = _engines("edgeserving", profiler=True, tracer=True)
    cold = port.scheduler.table
    seen = []
    ingest = port.profiler.ingest_quantum

    def spy(*args):
        table = ingest(*args)
        if table is not None:
            seen.append(table)
        return table

    port.profiler.ingest_quantum = spy
    _serve(port, _arrivals(P, 5))
    assert len(seen) == port.counters["profiler_refreshes"] > 0
    assert port.scheduler.table is seen[-1] and seen[-1] is not cold
    assert not np.array_equal(seen[-1].latency, cold.latency)


def test_safety_multiplier_events_equal_the_reference():
    port, ref = _engines("edgeserving", profiler=True, tracer=True,
                         slo=0.006, safety=True)
    assert _serve(port, _arrivals(P, 6)) == _serve(ref, _arrivals(R, 6))
    trace, ref_trace = port.trace(), ref.trace()
    assert plain(trace.events) == plain(ref_trace.events)
    assert "safety-multiplier" in [e.kind for e in trace.events]


def test_counters_and_tracer_accumulate_across_runs():
    """The engine is long-lived: counters add up over runs, the tracer is
    not reset by ``run()`` and each run ends in one counters event."""
    port, ref = _engines("edgeserving", profiler=True, tracer=True)
    for seed in (7, 8):
        assert _serve(port, _arrivals(P, seed)) == _serve(
            ref, _arrivals(R, seed))
    assert list(port.counters.items()) == list(ref.counters.items())
    trace = port.trace()
    assert [e.kind for e in trace.events].count("engine-counters") == 2
    assert plain(trace) == plain(ref.trace())


@pytest.mark.parametrize("policy", ["edgeserving", "symphony"])
def test_no_hooks_is_bitwise_the_stock_run(policy):
    """With both hooks ``None`` the run equals the reference's stock run;
    a tracer alone changes no decision."""
    slo = 0.012 if policy == "symphony" else 0.05
    stock, ref = _engines(policy, profiler=False, tracer=False, slo=slo)
    traced, _ = _engines(policy, profiler=False, tracer=True, slo=slo)
    got = _serve(stock, _arrivals(P, 9))
    assert got == _serve(ref, _arrivals(R, 9))
    assert got == _serve(traced, _arrivals(P, 9))
    assert stock.counters == traced.counters == dict(ref.counters)
    assert stock.counters["profiler_refreshes"] == 0
    assert stock.profiler is None and stock.tracer is None
