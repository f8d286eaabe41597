"""The port's serving simulator against the JAX reference's on the CPU.

With the default ``numpy`` scoring backend the event loop, the traces, the
noise, the drift, the online profiler and the metrics are host float64 in
both packages, op for op, so every ``ServingMetrics`` field, every kept
decision, the span and the adapted table must be equal with ``==``. The
float32 ``torch`` and ``cuda`` backends (run here on ``device="cpu"``, the
``cuda`` one through its kernel's plain version) must decide as the float64
backend does, up to float32 ties.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro_torch.core import (
    SCHEDULERS,
    AdaptConfig,
    ProfileTable,
    SchedulerConfig,
    ServingSimulator,
    VectorizedEdgeServingScheduler,
    make_drift,
    make_scheduler,
    paper_rate_vector,
    poisson_arrivals,
    run_experiment,
)
from repro_torch.kernels import launch_counts, reset_launch_counts

HORIZON = 2.0
RATES = paper_rate_vector(140.0)
TIE_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-4  # the stability kernel against its plain version


def _plain(x):
    """Dataclasses as nested tuples, NaN made comparable with ``==``."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _assert_results_equal(got, want):
    assert _plain(got.metrics) == _plain(want.metrics)
    assert _plain(got.traces) == _plain(want.traces)
    assert _plain(got.completions) == _plain(want.completions)
    assert got.span == want.span
    if want.adapted_table is None:
        assert got.adapted_table is None
    else:
        assert (got.adapted_table.latency.tobytes()
                == want.adapted_table.latency.tobytes())
        assert got.adapted_table.meta == want.adapted_table.meta


def _run_both(policy, slo=0.050, lattice=False, noise=0.0, drift=None,
              drift_kwargs=(), adapt=None, seed=7):
    """The same cell through ``run_experiment`` of the reference, then of
    the port."""
    out = []
    for api in (R, P):
        table = api.ProfileTable.paper_rtx3080()
        sched = api.make_scheduler(policy, table, api.SchedulerConfig(
            slo=slo, max_batch=10, lattice=lattice))
        out.append(api.run_experiment(
            sched, table, RATES, horizon=HORIZON, seed=seed,
            service_noise_cov=noise, keep_traces=True,
            drift=api.make_drift(drift, **dict(drift_kwargs)),
            adapt=None if adapt is None else api.AdaptConfig(**adapt)))
    return out


@pytest.mark.parametrize("policy", sorted(R.SCHEDULERS))
def test_every_policy_equals_the_reference(policy):
    assert sorted(SCHEDULERS) == sorted(R.SCHEDULERS)
    want, got = _run_both(policy)
    assert want.metrics.num_completed > 100
    _assert_results_equal(got, want)


THROTTLE = (("onset", 0.5), ("ramp", 1.0), ("peak", 2.2))
CELLS = {
    "noise": dict(policy="edgeserving", noise=0.03),
    "lattice_slo30_noise": dict(policy="edgeserving-lattice", slo=0.030,
                                noise=0.03),
    "throttle_adapt": dict(policy="edgeserving", drift="thermal-throttle",
                           drift_kwargs=THROTTLE,
                           adapt=dict(refresh_every=0.25)),
    "contention_adapt_mean_safety": dict(
        policy="edgeserving-lattice", drift="contention",
        drift_kwargs=(("burst_rate", 4.0), ("burst_duration", 0.2)),
        adapt=dict(mode="mean", safety=True, refresh_every=0.2)),
    "dvfs_static_symphony": dict(policy="symphony", drift="dvfs-step",
                                 drift_kwargs=(("steps", ((1.0, 1.8),)),)),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_noise_drift_and_adaptation_equal_the_reference(cell):
    want, got = _run_both(**CELLS[cell])
    _assert_results_equal(got, want)
    if CELLS[cell].get("adapt"):
        assert got.adapted_table.meta["observations"] > 0
        assert got.adapted_table.meta["drift_ratio"] != 1.0


def _simulator(policy="edgeserving", backend="numpy", **kwargs):
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler(policy, table, SchedulerConfig(
        slo=0.050, max_batch=10, backend=backend, device="cpu"))
    return ServingSimulator(sched, table, num_models=3, seed=3, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(service_noise_cov=0.03),
    dict(drift=make_drift("contention"), adapt=AdaptConfig(refresh_every=0.2)),
], ids=["noise", "contention_adapt"])
def test_a_rerun_is_bitwise_the_first_run(kwargs):
    sim = _simulator(**kwargs)
    static = sim.scheduler.table
    arrivals = poisson_arrivals(RATES, HORIZON, seed=3)
    first = sim.run(arrivals, HORIZON, keep_traces=True)
    assert sim.scheduler.table is static  # the refreshed table is undone
    _assert_results_equal(sim.run(arrivals, HORIZON, keep_traces=True), first)


def test_a_tracer_is_not_ported_and_raises():
    """The name is kept from before the tracer was ported, when it raised.
    It now holds that the simulator and ``run_experiment`` take a
    ``Tracer`` and return its frozen trace, with metrics bitwise those of
    the untraced run, and no trace without one (the port's telemetry is
    held against the reference in ``tests/test_torch_telemetry.py``)."""
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler("edgeserving", table, SchedulerConfig())
    traced = ServingSimulator(sched, table, tracer=P.Tracer()).run(
        poisson_arrivals(RATES, 0.5, seed=0), 0.5)
    plain = run_experiment(sched, table, RATES, horizon=0.5)
    assert plain.trace is None
    assert traced.trace.meta["engine"] == "python"
    assert len(traced.trace.spans) == traced.trace.meta["n_arrivals"]
    assert _plain(traced.metrics) == _plain(plain.metrics)
    assert _plain(run_experiment(sched, table, RATES, horizon=0.5,
                                 tracer=P.Tracer()).metrics) == _plain(
        plain.metrics)


# ---------------------------------------------------------------------------
# The float32 backends: the numpy decisions, up to float32 ties
# ---------------------------------------------------------------------------


def _record(sim):
    """Keep every round's (snapshot, the table decided with, decision)."""
    rounds, decide = [], sim.scheduler.decide

    def recording(snapshot):
        d = decide(snapshot)
        rounds.append((snapshot, sim.scheduler.table, d))
        return d

    sim.scheduler.decide = recording
    return rounds


def _score64(policy, table, snapshot, pick):
    """The float64 score of the candidate ``(model, exit, batch)``."""
    sched = VectorizedEdgeServingScheduler(table, SchedulerConfig(
        slo=0.050, max_batch=10, lattice=policy == "edgeserving-lattice"))
    cq, cb, ce, cl, _ = sched.enumerate_candidates(snapshot)
    scores = sched.score_candidates(snapshot, cl, cb, cq)
    (i,) = [i for i in range(len(cq)) if (cq[i], ce[i], cb[i]) == pick]
    return float(scores[i])


def _shadow_ties(policy, rounds):
    """Decide every recorded round again with the float64 numpy scheduler
    on the same snapshot and table; a decision that differs must be a
    float32 tie. Returns the number of ties."""
    shadow = make_scheduler(policy, ProfileTable.paper_rtx3080(),
                            SchedulerConfig(slo=0.050, max_batch=10))
    ties = 0
    for snapshot, table, d in rounds:
        shadow.table = table
        ds = shadow.decide(snapshot)
        if d is None or ds is None:
            assert d is ds
            continue
        pick = (d.model, d.exit_idx, d.batch_size)
        s64 = _score64(policy, table, snapshot, pick)
        np.testing.assert_allclose(d.stability_score, s64, rtol=RTOL,
                                   atol=ATOL)
        if pick == (ds.model, ds.exit_idx, ds.batch_size):
            continue
        s_host = _score64(policy, table, snapshot,
                          (ds.model, ds.exit_idx, ds.batch_size))
        assert abs(s64 - s_host) <= TIE_RTOL * abs(s_host), (pick, ds)
        ties += 1
    return ties


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("policy,adapt", [
    ("edgeserving", False), ("edgeserving-lattice", False),
    ("edgeserving", True)])
def test_float32_backends_decide_as_numpy(backend, policy, adapt):
    kwargs = (dict(drift=make_drift("thermal-throttle", **dict(THROTTLE)),
                   adapt=AdaptConfig(refresh_every=0.25)) if adapt else {})
    arrivals = poisson_arrivals(RATES, HORIZON, seed=3)
    f64 = _simulator(policy, **kwargs).run(arrivals, HORIZON,
                                          keep_traces=True)
    sim = _simulator(policy, backend=backend, **kwargs)
    rounds = _record(sim)
    reset_launch_counts()
    got = sim.run(arrivals, HORIZON, keep_traces=True)
    assert launch_counts["stability_score"] == 0  # the CPU launches none
    scored = [r for r in rounds if r[0].nonempty()]
    assert len(scored) > 100
    if adapt:
        assert len({id(table) for _, table, _ in rounds}) > 2
    if _shadow_ties(policy, rounds) == 0:
        assert _plain(got.metrics) == _plain(f64.metrics)
        assert ([_plain(t.decision)[:3] for t in got.traces]
                == [_plain(t.decision)[:3] for t in f64.traces])
