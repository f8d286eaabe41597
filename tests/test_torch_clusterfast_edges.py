"""The port's compiled cluster scan on the CPU: the ring's overflow retry,
empty arrivals, the G=1 collapse onto the single-device scan, the array
rollup, and the reference's loud rejections (each raised by the reference
and by the port on the same inputs).
"""

import dataclasses

import pytest

import repro.core as R
from repro.core import clusterfast as ref_clusterfast
from repro_torch.core import (
    ClusterSimulator,
    DeviceSpec,
    ScanEngineUnsupported,
    SchedulerConfig,
    Tracer,
    make_drift,
    make_fleet,
    make_scheduler,
    simulate_cluster_scan,
    simulate_scan,
)
from test_torch_clusterfast import arrivals, run_three, tables


def test_overflow_retry_widens_the_ring():
    run_three("homogeneous", 2, 150.0, 0.5, seed=5, dispatcher="jsq",
              max_queue=8)


def test_empty_arrivals():
    table, _ = tables()
    fleet = make_fleet("homogeneous", 2, table)
    res = simulate_cluster_scan(fleet, [], 1.0, device="cpu")
    assert res.metrics == ClusterSimulator(fleet).run([], 1.0).metrics
    assert res.metrics.num_completed == 0


def test_g1_collapses_to_simulate_scan_bitwise():
    """A one-device fleet is the single-device scan: the same completions,
    and the same metrics apart from the per-device rows and the fleet's
    span-based utilisation."""
    table, _ = tables()
    lane = arrivals(120.0, 1.5, 9)[0]
    one = simulate_scan(make_scheduler("edgeserving", table,
                                       SchedulerConfig(slo=0.05)),
                        table, lane, 1.5, keep_completions=True,
                        device="cpu")
    fleet = simulate_cluster_scan(make_fleet("homogeneous", 1, table), lane,
                                  1.5, device="cpu")
    assert one.completions == fleet.completions
    assert one.metrics == dataclasses.replace(
        fleet.metrics, per_device=(), utilization=one.metrics.utilization)


def test_array_rollup_equals_object_rollup():
    """``keep_completions=False`` settles the books through
    ``summarize_arrays``; the metrics may not move by a bit."""
    table, _ = tables()
    lane = arrivals(120.0, 0.7, 21)[0]
    fleet = make_fleet("heterogeneous", 3, table, fail_at=((1, 0.35),))
    a = simulate_cluster_scan(fleet, lane, 0.7, dispatcher="jsq",
                              keep_completions=True, device="cpu")
    b = simulate_cluster_scan(fleet, lane, 0.7, dispatcher="jsq",
                              keep_completions=False, device="cpu")
    assert a.metrics == b.metrics
    assert b.completions == []


# -- loud rejection: the reference's cases, raised by the port too ----------

def _rejects(port_kwargs, ref_kwargs=None, exc=ScanEngineUnsupported,
             match=None, fleet=None):
    table, ref_table = tables()
    port_fleet, ref_fleet = (fleet(table, DeviceSpec),
                             fleet(ref_table, R.DeviceSpec)) if fleet else (
        make_fleet("homogeneous", 3, table),
        R.make_fleet("homogeneous", 3, ref_table))
    ref_exc = R.ScanEngineUnsupported if exc is ScanEngineUnsupported else exc
    with pytest.raises(ref_exc, match=match):
        ref_clusterfast.simulate_cluster_scan(
            ref_fleet, [], 1.0, **(port_kwargs if ref_kwargs is None
                                   else ref_kwargs))
    with pytest.raises(exc, match=match):
        simulate_cluster_scan(port_fleet, [], 1.0, device="cpu",
                              **port_kwargs)


def test_power_of_d_subsample_rejected():
    _rejects(dict(dispatcher="stability-aware", power_d=2),
             match="power-of-d")


def test_tracer_rejected():
    table, ref_table = tables()
    with pytest.raises(R.ScanEngineUnsupported, match="telemetry"):
        ref_clusterfast.simulate_cluster_scan(
            R.make_fleet("homogeneous", 2, ref_table), [], 1.0,
            tracer=R.Tracer())
    with pytest.raises(ScanEngineUnsupported, match="telemetry"):
        simulate_cluster_scan(make_fleet("homogeneous", 2, table), [], 1.0,
                              tracer=Tracer(), device="cpu")


def test_service_noise_rejected():
    _rejects(dict(service_noise_cov=0.05), match="noise")


def test_per_device_drift_rejected():
    table, ref_table = tables()
    with pytest.raises(R.ScanEngineUnsupported, match="drift"):
        ref_clusterfast.simulate_cluster_scan(
            R.make_fleet("homogeneous", 2, ref_table,
                         drift=((0, R.make_drift("thermal-throttle")),)),
            [], 1.0)
    with pytest.raises(ScanEngineUnsupported, match="drift"):
        simulate_cluster_scan(
            make_fleet("homogeneous", 2, table,
                       drift=((0, make_drift("thermal-throttle")),)),
            [], 1.0, device="cpu")


def test_unequal_exit_counts_rejected():
    def fleet(table, spec):
        return [spec(table=table, name="full"),
                spec(table=table.restrict_exits([table.num_exits - 1]),
                     name="final-only")]
    _rejects({}, match="exits", fleet=fleet)


@pytest.mark.parametrize("policy", ["symphony", "all-final", "earlyexit-edf"])
def test_non_algorithm1_policy_rejected(policy):
    _rejects(dict(policy=policy))


def test_non_numpy_backend_rejected():
    """The reference rejects its ``jnp`` backend; the port its ``torch``
    backend (the same knob)."""
    _rejects(dict(config=SchedulerConfig(slo=0.05, backend="torch",
                                         device="cpu")),
             ref_kwargs=dict(config=R.SchedulerConfig(slo=0.05,
                                                      backend="jnp")))


def test_unknown_dispatcher_is_value_error():
    _rejects(dict(dispatcher="fortune-teller"), exc=ValueError,
             match="unknown dispatcher")
