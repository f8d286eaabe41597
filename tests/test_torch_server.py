"""The port's live serving engine on the CPU: conservation with the SMOKE
ResNets, the measured profile, and completion logs equal to the reference
engine's under the same table, arrivals and a deterministic counter clock."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ProfileTable as RefTable
from repro.core import SchedulerConfig as RefConfig
from repro.core import make_scheduler as ref_make_scheduler
from repro.core import poisson_arrivals as ref_arrivals
from repro.runtime.server import ServedModel as RefServed
from repro.runtime.server import ServingEngine as RefEngine

from repro_torch.configs import SMOKE
from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    make_scheduler,
    paper_rate_vector,
    poisson_arrivals,
)
from repro_torch.runtime.server import (
    ServedModel,
    ServingEngine,
    measure_profile,
    serve_resnets,
)


class CounterClock:
    """Deterministic clock: each read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def resnets():
    return serve_resnets(SMOKE, device="cpu", max_batch=4)


@pytest.fixture(scope="module")
def measured(resnets):
    return measure_profile(resnets, batch_sizes=[1, 2, 4], repeats=2,
                           warmup=1)


def test_measured_profile_shape_monotone_and_platform(measured):
    assert measured.latency.shape == (3, 4, 3)
    assert np.all(measured.latency > 0)
    assert np.all(np.diff(measured.latency, axis=2) >= 0)
    assert measured.meta["platform"] == "cpu"
    assert measured.meta["builder"] == "measure"


def test_resnet_payload_is_one_device_tensor(resnets):
    x4, x2 = resnets[0].data_fn(4), resnets[0].data_fn(2)
    assert x4.shape == (4, 32, 32, 3) and x2.data_ptr() == x4.data_ptr()
    out = resnets[2].forward_fn(resnets[2].values, x2, 3)
    assert out.shape == (2, 100) and torch.isfinite(out).all()


@pytest.mark.parametrize("policy,backend", [
    ("edgeserving", "numpy"), ("edgeserving", "cuda"),
    ("edgeserving-lattice", "torch"), ("symphony", "numpy")])
def test_engine_conserves_arrivals(resnets, measured, policy, backend):
    sched = make_scheduler(policy, measured, SchedulerConfig(
        slo=0.5, max_batch=4, backend=backend, device="cpu"))
    engine = ServingEngine(resnets, sched)
    engine.warmup()
    arrivals = poisson_arrivals(paper_rate_vector(15), 0.4, seed=3)
    completions, span = engine.run(arrivals, duration=0.4, drain=True)
    m = engine.metrics(measured, slo=0.5, span=span)
    assert len(completions) + engine.dropped + m.residual_queue == len(
        arrivals)
    assert sorted(c.req_id for c in completions) == sorted(
        set(c.req_id for c in completions))
    assert engine.counters["requests_served"] == len(completions)
    # quanta are serial: one quantum's dispatch follows the last one's finish
    spans = sorted({(c.dispatch, c.finish) for c in completions})
    for (_, f1), (d2, _) in zip(spans, spans[1:]):
        assert d2 >= f1


def _run_both(policy, port_backend, horizon=0.3, lam=140.0):
    arrivals_ref = ref_arrivals(paper_rate_vector(lam), horizon, seed=0)
    arrivals = poisson_arrivals(paper_rate_vector(lam), horizon, seed=0)
    ref_table = RefTable.paper_rtx3080()
    table = ProfileTable.paper_rtx3080()
    ref_engine = RefEngine(
        [RefServed(f"m{m}", None, lambda v, x, e: x.sum(),
                   lambda b: jnp.ones((b, 2)), 4) for m in range(3)],
        ref_make_scheduler(policy, ref_table, RefConfig(slo=0.05)),
        clock=CounterClock())
    engine = ServingEngine(
        [ServedModel(f"m{m}", None, lambda v, x, e: x.sum(),
                     lambda b: torch.ones((b, 2)), 4) for m in range(3)],
        make_scheduler(policy, table, SchedulerConfig(
            slo=0.05, backend=port_backend, device="cpu")),
        clock=CounterClock())
    ref_log, ref_span = ref_engine.run(arrivals_ref, horizon, idle_sleep=0.0)
    log, span = engine.run(arrivals, horizon, idle_sleep=0.0)
    return (ref_engine, ref_log, ref_span, ref_table), (engine, log, span,
                                                       table)


@pytest.mark.parametrize("policy,port_backend", [
    ("edgeserving", "numpy"), ("edgeserving", "cuda"),
    ("edgeserving", "torch"), ("edgeserving-lattice", "numpy"),
    ("symphony", "numpy"), ("all-final", "numpy")])
def test_completion_log_equals_reference_engine(policy, port_backend):
    (ref_engine, ref_log, ref_span, ref_table), (
        engine, log, span, table) = _run_both(policy, port_backend)
    assert len(log) > 100
    assert [dataclasses.astuple(c) for c in log] == [
        dataclasses.astuple(c) for c in ref_log]
    assert span == ref_span
    assert engine.dropped == ref_engine.dropped
    # all six keys, in the reference's order (profiler_refreshes is 0
    # without a profiler)
    assert list(engine.counters.items()) == list(ref_engine.counters.items())
    assert dataclasses.asdict(engine.metrics(table, 0.05, span)) == (
        dataclasses.asdict(ref_engine.metrics(ref_table, 0.05, ref_span)))


def test_drain_cap_counts_unsubmitted_tail():
    engine = ServingEngine(
        [ServedModel("m0", None, lambda v, x, e: x, lambda b: b, 4)],
        make_scheduler("symphony", ProfileTable.paper_rtx3080(),
                       SchedulerConfig(slo=0.05)),
        clock=CounterClock())
    from repro_torch.core import Request

    arrivals = [Request(0, 0, 0.0), Request(1, 0, 30.0)]
    completions, span = engine.run(arrivals, duration=0.01, idle_sleep=0.0,
                                   drain_cap=0.05)
    m = engine.metrics(ProfileTable.paper_rtx3080(), 0.05, span)
    assert len(completions) + engine.dropped + m.residual_queue == 2
