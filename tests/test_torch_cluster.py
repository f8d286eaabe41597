"""The port's cluster tier against the JAX reference's on the CPU.

``ClusterSimulator``, the dispatchers, the fleets and the per-device
rollup are host numpy in both packages, op for op: with the ``numpy``
scoring backend a cell's ``ClusterResult`` (aggregate and per-device
metrics, merged completions, span, and its traced timeline down to the
exported bytes) must equal the reference's with ``==``, for every
dispatcher on both fleets, with and without a device failure, and under
per-device drift with online adaptation. Through ``repro_torch`` alone the
four fig14 goldens hold at the reference's rtol=1e-9, quoted strings
included, and a one-device cluster is bitwise the single-device simulator.

Fixed seeds and loads replace the reference's hypothesis draws
(``tests/test_dispatch_invariants.py``).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro_torch.core import (
    DISPATCHERS,
    FLEETS,
    AdaptConfig,
    ClusterSimulator,
    DeviceLoadView,
    DeviceMetrics,
    ProfileTable,
    SchedulerConfig,
    ServingSimulator,
    SweepRunner,
    SweepSpec,
    Tracer,
    drain_cell,
    drain_estimate,
    export_chrome_trace,
    export_ndjson,
    make_dispatcher,
    make_fleet,
    make_scheduler,
    paper_rate_vector,
)

from torch_compare import plain, ref_spec

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_metrics.json"
FLEET_CELLS = [("homogeneous", 2, 320.0), ("heterogeneous", 4, 560.0)]
VARIANTS = {
    "stock": {},
    "fail": dict(fail_at=((1, 0.6),)),
    "drift_adapt": dict(drift="thermal-throttle",
                        drift_kwargs=(("onset", 0.3), ("ramp", 0.4)),
                        adapt=AdaptConfig(refresh_every=0.2)),
}


def _arrivals(pkg, lam, horizon=2.0, seed=7, scenario="poisson"):
    return pkg.make_scenario(scenario, paper_rate_vector(lam)).generate(
        horizon, seed=seed)


# ---------------------------------------------------------------------------
# The fig14 goldens, through repro_torch alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell,quoted", [
    ("het/stability-aware", "3.02%"),
    ("het/round-robin", "18.65%"),
    ("het/jsq", "13.30%"),
    ("scaling/G1/least-loaded", "0.45%"),
])
def test_fig14_summary_pins(cell, quoted):
    entry = json.loads(GOLDEN.read_text())["fig14"][cell]
    assert entry["quoted"] == quoted
    leg, dispatcher = cell.split("/")[0], cell.rsplit("/", 1)[1]
    fleet, size, rate = (("heterogeneous", 4, 640.0) if leg == "het"
                         else ("homogeneous", 1, 140.0))
    res = SweepRunner(ProfileTable.paper_rtx3080()).run_cell(SweepSpec(
        policy="edgeserving", scenario="mmpp", rate=rate, seed=7,
        horizon=6.0, fleet=fleet, fleet_size=size, dispatcher=dispatcher))
    got = res.metrics.violation_ratio
    np.testing.assert_allclose(got, entry["violation_ratio"], rtol=1e-9)
    assert f"{got * 100:.2f}%" == quoted
    assert len(res.metrics.per_device) == size
    assert all(isinstance(d, DeviceMetrics) for d in res.metrics.per_device)


# ---------------------------------------------------------------------------
# Every dispatcher x fleet x variant against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("fleet,size,rate", FLEET_CELLS,
                         ids=[f"{f}x{s}" for f, s, _ in FLEET_CELLS])
@pytest.mark.parametrize("dispatcher", sorted(DISPATCHERS))
def test_cluster_cell_equals_the_reference(dispatcher, fleet, size, rate,
                                           variant, tmp_path):
    spec = SweepSpec(policy="edgeserving", scenario="mmpp", rate=rate,
                     seed=3, horizon=1.5, warmup_tasks=30, fleet=fleet,
                     fleet_size=size, dispatcher=dispatcher, trace=True,
                     **VARIANTS[variant])
    got = SweepRunner(ProfileTable.paper_rtx3080()).run_cell(spec)
    want = R.SweepRunner(R.ProfileTable.paper_rtx3080()).run_cell(
        ref_spec(spec))
    assert plain(got.metrics) == plain(want.metrics)
    assert plain(got.trace) == plain(want.trace)
    counts = got.trace.span_counts()
    assert sum(counts.values()) == got.trace.meta["n_arrivals"]
    assert counts["dropped"] == got.metrics.dropped
    assert counts["residual"] == got.metrics.residual_queue
    if variant == "fail":
        kinds = [e.kind for e in got.trace.events]
        assert kinds.count("device-failure") == kinds.count("failover") == 1
        assert not got.metrics.per_device[1].alive
    if variant == "drift_adapt":
        refreshes = {e.device for e in got.trace.events
                     if e.kind == "profiler-refresh"}
        assert refreshes == set(range(size))  # each device adapts alone
    for write, ref_write in ((export_ndjson, R.export_ndjson),
                             (export_chrome_trace, R.export_chrome_trace)):
        a, b = tmp_path / "port", tmp_path / "ref"
        write(got.trace, str(a))
        ref_write(want.trace, str(b))
        assert a.read_bytes() == b.read_bytes()


def test_cluster_result_and_direct_simulator_equal_the_reference():
    """``ClusterSimulator`` driven directly, with service noise and a
    placement map: merged completions, span and ``dispatch_counts`` too."""
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())

    def build(pkg, tab):
        fleet = pkg.make_fleet("heterogeneous", 3, tab, fail_at=((2, 0.9),))
        fleet[0] = dataclasses.replace(fleet[0], models=(0, 1))
        return pkg.ClusterSimulator(
            fleet, policy="edgeserving-lattice",
            config=pkg.SchedulerConfig(slo=0.040),
            dispatcher=pkg.make_dispatcher("stability-aware", slo=0.040,
                                           power_d=2),
            num_models=3, service_noise_cov=0.03, seed=11)

    got = build(P, table).run(_arrivals(P, 300.0), 2.0, warmup_tasks=40)
    want = build(R, ref_table).run(_arrivals(R, 300.0), 2.0,
                                   warmup_tasks=40)
    assert plain(got.metrics) == plain(want.metrics)
    assert plain(got.completions) == plain(want.completions)
    assert got.span == want.span and got.trace is None
    assert got.dispatch_counts == want.dispatch_counts
    assert sum(got.dispatch_counts) >= len(_arrivals(P, 300.0)) - (
        got.metrics.residual_queue)


# ---------------------------------------------------------------------------
# One device is the single-device simulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["edgeserving", "edgeserving-lattice",
                                    "all-final", "symphony"])
def test_g1_cluster_is_bitwise_the_single_device_run(policy):
    table = ProfileTable.paper_rtx3080()
    cfg = SchedulerConfig(slo=0.050)
    arrivals = _arrivals(P, 160.0, horizon=2.0, scenario="mmpp")
    single = ServingSimulator(make_scheduler(policy, table, cfg), table,
                              num_models=3, seed=7, service_noise_cov=0.02,
                              tracer=Tracer())
    want = single.run(list(arrivals), 2.0, warmup_tasks=50)
    got = ClusterSimulator(make_fleet("homogeneous", 1, table), policy=policy,
                           config=cfg, num_models=3, seed=7,
                           service_noise_cov=0.02, tracer=Tracer()).run(
        list(arrivals), 2.0, warmup_tasks=50)
    assert got.completions == want.completions
    assert got.span == want.span
    assert dataclasses.replace(got.metrics, per_device=()) == want.metrics
    assert len(got.metrics.per_device) == 1
    # the timelines differ only in the engine name and the residuals' device
    assert plain(got.trace.decisions) == plain(want.trace.decisions)
    assert got.trace.meta["engine"] == "cluster"


def test_g1_rerun_is_stable():
    sim = ClusterSimulator(make_fleet("homogeneous", 1,
                                      ProfileTable.paper_rtx3080()),
                           num_models=3, seed=7)
    arrivals = _arrivals(P, 120.0)
    assert sim.run(list(arrivals), 2.0).metrics == sim.run(
        list(arrivals), 2.0).metrics


# ---------------------------------------------------------------------------
# Fleets, dispatchers and the drain estimate against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FLEETS))
@pytest.mark.parametrize("size", [1, 2, 5])
def test_fleets_and_labels_equal_the_reference(name, size):
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    got = make_fleet(name, size, table, fail_at=((size - 1, 1.5),))
    want = R.make_fleet(name, size, ref_table, fail_at=((size - 1, 1.5),))
    assert [(s.name, s.fail_at, s.models, s.label(d))
            for d, s in enumerate(got)] == [
        (s.name, s.fail_at, s.models, s.label(d))
        for d, s in enumerate(want)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.table.latency, b.table.latency)
        assert a.table.meta == b.table.meta
    unnamed = dataclasses.replace(got[0], name="")
    assert unnamed.label(3) == dataclasses.replace(want[0], name="").label(3)


def test_fleet_and_dispatcher_errors_match_the_reference():
    table = ProfileTable.paper_rtx3080()
    with pytest.raises(ValueError, match="unknown fleet"):
        make_fleet("ring", 2, table)
    with pytest.raises(ValueError, match="unknown dispatcher"):
        make_dispatcher("random")
    with pytest.raises(AssertionError):
        make_fleet("homogeneous", 2, table, fail_at=((2, 1.0),))
    fleet = make_fleet("homogeneous", 2, table)
    fleet = [dataclasses.replace(s, models=(0, 1)) for s in fleet]
    with pytest.raises(AssertionError, match="placed on no device"):
        ClusterSimulator(fleet, num_models=3)


class _View(DeviceLoadView):
    """A scripted fleet state, as the reference's tests script it."""

    def __init__(self, backlogs, queued, service):
        self.backlogs, self.queued, self.service = backlogs, queued, service

    def healthy(self, d):
        return True

    def effective_backlog(self, d):
        return self.backlogs[d]

    def total_queued(self, d):
        return self.queued[d]

    def predicted_completion(self, d, model):
        return self.backlogs[d] + self.service[d]


class _RefView(_View, R.DeviceLoadView):
    pass


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("g", [2, 3, 8])
def test_dispatcher_picks_equal_the_reference(seed, g):
    """Fixed grid of seeds and fleet sizes: each dispatcher's pick sequence
    over shifting loads and eligible sets equals the reference's, the
    stability-aware power-of-d draws included."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(40):
        backlogs = rng.choice([0.0, 0.01, 0.02, 0.05], size=g).tolist()
        queued = rng.integers(0, 4, size=g).tolist()
        service = rng.uniform(0.001, 0.02, size=g).tolist()
        k = int(rng.integers(1, g + 1))
        eligible = sorted(rng.choice(g, size=k, replace=False).tolist())
        deadline = None if rng.uniform() < 0.5 else 0.03
        steps.append((backlogs, queued, service, eligible, deadline))
    for name in sorted(DISPATCHERS):
        for power_d in (1, 2, 3):
            got = make_dispatcher(name, slo=0.05, power_d=power_d)
            want = R.make_dispatcher(name, slo=0.05, power_d=power_d)
            got.reset(seed)
            want.reset(seed)
            picks = [(got.pick(0, e, _View(b, q, s), deadline=dl),
                      want.pick(0, e, _RefView(b, q, s), deadline=dl))
                     for b, q, s, e, dl in steps]
            assert [a for a, _ in picks] == [b for _, b in picks], name
    sa = make_dispatcher("stability-aware", slo=0.05)
    ref_sa = R.make_dispatcher("stability-aware", slo=0.05)
    for t in (0.0, 0.02, 0.05, 0.3, 2.0):
        assert sa.delta(t) == ref_sa.delta(t)
        assert sa.delta(t, deadline=0.03) == ref_sa.delta(t, deadline=0.03)


@pytest.mark.parametrize("policy,max_batch", [
    ("edgeserving", 10), ("edgeserving", 4), ("ours-bs1", 10),
    ("edgeserving-lattice", 6), ("symphony", 10)])
def test_drain_estimate_equals_the_reference(policy, max_batch):
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    sched = make_scheduler(policy, table, SchedulerConfig(max_batch=max_batch))
    ref = R.make_scheduler(policy, ref_table,
                           R.SchedulerConfig(max_batch=max_batch))
    rng = np.random.default_rng(max_batch)
    for qlens in [(0, 0, 0), (1, 0, 0), (10, 11, 23)] + [
            tuple(rng.integers(0, 65, 3).tolist()) for _ in range(20)]:
        for e in (None, 0, 2):
            assert drain_estimate(sched, qlens, e) == R.drain_estimate(
                ref, qlens, e)
        for m, n in enumerate(qlens):
            assert drain_cell(sched, m, n) == R.drain_cell(ref, m, n)


# ---------------------------------------------------------------------------
# Sweeps of fleet cells, and the cuda backend on the CPU
# ---------------------------------------------------------------------------


def test_fleet_cells_two_workers_equal_serial_bitwise():
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    specs = runner.cluster_grid(
        ("least-loaded", "stability-aware"),
        (("homogeneous", 2), ("heterogeneous", 4)),
        scenarios=("mmpp",), rates=(400.0,), horizon=1.0, warmup_tasks=20)
    specs.append(SweepSpec(policy="edgeserving", fleet="heterogeneous",
                           fleet_size=4, rate=500.0, horizon=1.0,
                           warmup_tasks=20, fail_at=((1, 0.5),),
                           backend="cuda", device="cpu", trace=True))
    serial = runner.run(specs, workers=1)
    parallel = runner.run(specs, workers=2)
    assert [r.spec for r in parallel] == specs
    assert ([plain(r.metrics) for r in parallel]
            == [plain(r.metrics) for r in serial])
    assert plain(parallel[-1].trace.spans) == plain(serial[-1].trace.spans)


@pytest.mark.parametrize("dispatcher", ["stability-aware", "jsq"])
def test_cuda_backend_fleet_cell_decides_as_numpy(dispatcher):
    """Every device's scheduler scores through the one cached ``cuda``
    backend (its kernel's plain version on the CPU), one round at a time;
    with no float32 tie the cell's metrics equal the numpy cell's."""
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    base = dict(policy="edgeserving", scenario="mmpp", rate=640.0, seed=7,
                horizon=2.0, fleet="heterogeneous", fleet_size=4,
                dispatcher=dispatcher)
    f64 = runner.run_cell(SweepSpec(**base))
    f32 = runner.run_cell(SweepSpec(**base, backend="cuda", device="cpu"))
    assert plain(f32.metrics) == plain(f64.metrics)
    sims = [runner.simulator(SweepSpec(**base, backend="cuda", device="cpu"))
            for _ in range(2)]
    for sim in sims:
        sim.run([], 0.0)
    backends = {id(dev.scheduler.scoring) for sim in sims
                for dev in sim._devs}
    assert len(backends) == 1
