"""The port's compiled cluster scan against the reference's and the port's
``ClusterSimulator``, on the CPU: every dispatcher on a homogeneous and a
heterogeneous fleet.

``repro_torch.core.clusterfast`` runs G per-device Algorithm-1 schedulers
behind a compiled dispatcher step, one float64 step over many lanes. On the
same arrivals it must dispatch, decide and complete as both other engines
do, so completions, span and ``ServingMetrics`` (``per_device`` included)
are equal with ``==``. Fail-over is in
``tests/test_torch_clusterfast_failover.py``; the overflow retry, the G=1
collapse and the loud rejections in ``tests/test_torch_clusterfast_edges.py``.
"""

import dataclasses

import pytest

import repro.core as R
from repro.core import clusterfast as ref_clusterfast
from repro_torch.core import (
    SUPPORTED_DISPATCHERS,
    ClusterSimulator,
    DeviceSpec,
    ProfileTable,
    SchedulerConfig,
    make_dispatcher,
    make_fleet,
    paper_rate_vector,
    poisson_arrivals,
    simulate_cluster_scan,
    simulate_cluster_scan_batch,
)

SLO = 0.05


def tables():
    return (ProfileTable.paper_rtx3080().with_batch_saturation(4),
            R.ProfileTable.paper_rtx3080().with_batch_saturation(4))


def arrivals(lam, horizon, seed):
    return (poisson_arrivals(paper_rate_vector(lam), horizon, seed=seed),
            R.poisson_arrivals(R.paper_rate_vector(lam), horizon, seed=seed))


def plain_completions(res):
    return [dataclasses.astuple(c) for c in res.completions]


def run_three(fleet, size, lam, horizon, seed, dispatcher="least-loaded",
              power_d=2, fail_at=(), devices=None, **scan_kw):
    """The same fleet and arrivals through the port's cluster scan, the
    reference's cluster scan and the port's ClusterSimulator; all three
    must agree bitwise. Returns the port scan's result."""
    table, ref_table = tables()
    port_arr, ref_arr = arrivals(lam, horizon, seed)
    if devices is None:
        port_fleet = make_fleet(fleet, size, table, fail_at=fail_at)
        ref_fleet = R.make_fleet(fleet, size, ref_table, fail_at=fail_at)
    else:
        port_fleet = devices(table, DeviceSpec)
        ref_fleet = devices(ref_table, R.DeviceSpec)
    got = simulate_cluster_scan(
        port_fleet, port_arr, horizon, config=SchedulerConfig(slo=SLO),
        dispatcher=dispatcher, power_d=power_d, device="cpu", **scan_kw)
    want = ref_clusterfast.simulate_cluster_scan(
        ref_fleet, ref_arr, horizon, config=R.SchedulerConfig(slo=SLO),
        dispatcher=dispatcher, power_d=power_d, **scan_kw)
    py = ClusterSimulator(
        port_fleet, config=SchedulerConfig(slo=SLO),
        dispatcher=make_dispatcher(dispatcher, slo=SLO, power_d=power_d),
    ).run(port_arr, horizon)
    assert dataclasses.asdict(got.metrics) == dataclasses.asdict(want.metrics)
    assert plain_completions(got) == plain_completions(want)
    assert got.span == want.span == py.span
    assert got.metrics == py.metrics
    assert got.completions == py.completions
    m = got.metrics
    assert len(got.completions) + m.residual_queue + m.dropped == len(port_arr)
    return got


@pytest.mark.parametrize("fleet", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("dispatcher", SUPPORTED_DISPATCHERS)
def test_dispatcher_fleet_grid_bitwise(dispatcher, fleet):
    res = run_three(fleet, 3, 100.0, 0.8, seed=7, dispatcher=dispatcher,
                    power_d=3)
    assert all(d.dispatched > 0 for d in res.metrics.per_device)


def test_partial_placement_bitwise():
    """Model 2 lives on device 1 only; dispatch must respect placement."""
    def devices(table, spec):
        return [spec(table=table, name="a", models=(0, 1)),
                spec(table=table, name="b", models=(0, 1, 2))]
    run_three(None, 2, 100.0, 1.0, seed=5, dispatcher="jsq",
              devices=devices)


def test_batch_lanes_equal_single_runs():
    table, _ = tables()
    fleet = make_fleet("homogeneous", 2, table)
    lanes = [arrivals(80.0, 1.0, s)[0] for s in (1, 2, 3)]
    batch = simulate_cluster_scan_batch(fleet, lanes, 1.0,
                                        dispatcher="least-loaded",
                                        device="cpu")
    for lane, got in zip(lanes, batch):
        one = simulate_cluster_scan(fleet, lane, 1.0,
                                    dispatcher="least-loaded", device="cpu")
        assert got.metrics == one.metrics
        assert got.completions == one.completions
