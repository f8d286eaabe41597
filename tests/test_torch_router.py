"""The port's replica router and fault-tolerance helpers against the JAX
reference's on the CPU.

``ReplicaRouter``, ``StragglerPolicy`` and ``ElasticMesh.propose`` are host
code in both packages, line for line, so over a fixed grid of seeds,
replica counts, loads, straggler observations and dispatchers (in place of
the reference's hypothesis draws) the port's picks and router state must
equal the reference's. ``ElasticMesh.build`` needs the port's device mesh
and raises ``NotImplementedError``.
"""

import dataclasses
import signal

import numpy as np
import pytest

import repro.core as R
from repro.runtime import fault_tolerance as RF
from repro.runtime.router import ReplicaRouter as RefRouter

from repro_torch.core import (
    DISPATCHERS,
    ProfileTable,
    SchedulerConfig,
    make_dispatcher,
    make_scheduler,
)
from repro_torch.runtime.fault_tolerance import (
    ElasticMesh,
    PreemptionGuard,
    StragglerPolicy,
)
from repro_torch.runtime.router import ReplicaRouter, ReplicaState

SEEDS = range(8)


def _state(router):
    return ([dataclasses.astuple(r) for r in router.replicas],
            router.straggler.multipliers.tolist(), router._service_share)


def _script(seed, n):
    """A fixed script of router operations drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        kind = rng.choice(["report", "report_q", "observe", "route",
                           "route_key", "batch", "batch_key"])
        i = int(rng.integers(n))
        if kind == "report":
            ops.append((kind, i, float(rng.choice([0.0, 0.05, 0.2, 1.5]))))
        elif kind == "report_q":
            ops.append((kind, i, float(rng.uniform(0, 0.5)),
                        tuple(rng.integers(0, 20, 3).tolist())))
        elif kind == "observe":
            ops.append((kind, i, float(rng.uniform(0.001, 0.05)),
                        float(rng.choice([0.001, 0.01, 0.02]))))
        elif kind in ("route", "route_key"):
            ops.append((kind, int(rng.integers(3)),
                        f"s{int(rng.integers(40))}"))
        else:
            ops.append((kind, int(rng.integers(1, 9)), int(rng.integers(3))))
    return ops


def _play(router, ops):
    picks = []
    for op in ops:
        kind = op[0]
        if kind == "report":
            router.update_backlog(op[1], op[2])
        elif kind == "report_q":
            router.update_backlog(op[1], op[2], qlens=op[3])
        elif kind == "observe":
            router.observe_quantum(op[1], observed_s=op[2], expected_s=op[3])
        elif kind == "route":
            picks.append(router.route(model=op[1]))
        elif kind == "route_key":
            picks.append(router.route(key=op[2], model=op[1]))
        elif kind == "batch":
            picks.append(tuple(router.route_batch(op[1], model=op[2])))
        else:
            picks.append(tuple(router.route_batch(op[1], key_prefix="k",
                                                  model=op[2])))
        picks.append(_state(router))
    return picks


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dispatcher", sorted(DISPATCHERS))
@pytest.mark.parametrize("with_table", [False, True])
def test_router_script_equals_the_reference(seed, n, dispatcher, with_table):
    table = ProfileTable.paper_rtx3080() if with_table else None
    ref_table = R.ProfileTable.paper_rtx3080() if with_table else None
    kw = dict(spill_factor=1.5, max_batch=8)
    got = ReplicaRouter(n, straggler=StragglerPolicy(n, alpha=0.5),
                        table=table,
                        dispatcher=make_dispatcher(dispatcher, slo=0.05),
                        **kw)
    want = RefRouter(n, straggler=RF.StragglerPolicy(n, alpha=0.5),
                     table=ref_table,
                     dispatcher=R.make_dispatcher(dispatcher, slo=0.05),
                     **kw)
    ops = _script(seed, n)
    assert _play(got, ops) == _play(want, ops)


def test_default_router_and_degraded_fleet_equal_the_reference():
    got, want = ReplicaRouter(3), RefRouter(3)
    assert type(got.dispatcher).__name__ == type(want.dispatcher).__name__
    for r in (got, want):
        for i in range(3):
            r.observe_quantum(i, observed_s=1.0, expected_s=0.01)
    assert not any(r.healthy for r in got.replicas)
    assert got.route_batch(7) == want.route_batch(7) == [0, 1, 2, 0, 1, 2, 0]
    assert got.route() == want.route()
    assert ReplicaState() == ReplicaState(0.0, True, None, 0)


@pytest.mark.parametrize("max_batch", [1, 4, 10])
def test_backlog_estimates_equal_the_reference(max_batch):
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    sched = make_scheduler("edgeserving", table,
                           SchedulerConfig(max_batch=max_batch))
    ref = R.make_scheduler("edgeserving", ref_table,
                           R.SchedulerConfig(max_batch=max_batch))
    rng = np.random.default_rng(max_batch)
    for qlens in [(0, 0, 0), (25, 0, 7)] + [
            tuple(rng.integers(0, 65, 3).tolist()) for _ in range(25)]:
        for e in (None, 1):
            assert ReplicaRouter.backlog_from_queues(
                table, qlens, e, max_batch) == RefRouter.backlog_from_queues(
                ref_table, qlens, e, max_batch)
            assert ReplicaRouter.backlog_from_scheduler(
                sched, qlens, e) == RefRouter.backlog_from_scheduler(
                ref, qlens, e)


@pytest.mark.parametrize("seed", SEEDS)
def test_straggler_policy_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    got, want = (StragglerPolicy(4, alpha=0.3, detach_threshold=2.5),
                 RF.StragglerPolicy(4, alpha=0.3, detach_threshold=2.5))
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    for _ in range(50):
        i = int(rng.integers(4))
        obs, exp = float(rng.uniform(0, 0.1)), float(rng.uniform(0, 0.03))
        got.observe(i, obs, exp)
        want.observe(i, obs, exp)
        assert got.multipliers.tolist() == want.multipliers.tolist()
        assert got.healthy() == want.healthy()
    for i in range(4):
        a, b = got.scale_profile(i, table), want.scale_profile(i, ref_table)
        np.testing.assert_array_equal(a.latency, b.latency)
        assert a.meta == b.meta


@pytest.mark.parametrize("model_axis", [1, 4, 16])
def test_elastic_mesh_propose_equals_the_reference(model_axis):
    got, want = ElasticMesh(model_axis), RF.ElasticMesh(model_axis)
    for n in range(model_axis, 8 * model_axis + 3):
        assert got.propose(n) == want.propose(n)
    if model_axis > 1:
        for mesh in (got, want):
            with pytest.raises(AssertionError, match="TP degree"):
                mesh.propose(model_axis - 1)


def test_elastic_mesh_build_equals_the_reference():
    import torch.distributed as dist

    from repro_torch.launch.mesh import release_mesh

    release_mesh()
    try:
        mesh, accum = ElasticMesh(1).build(device="cpu")
        want_mesh, want_accum = RF.ElasticMesh(1).build()
        assert tuple(mesh.shape) == tuple(want_mesh.devices.shape)
        assert mesh.mesh_dim_names == tuple(want_mesh.axis_names)
        assert accum == want_accum == 16
        assert dist.get_backend() == "gloo" and mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="ranks"):
            ElasticMesh(1).build(4, device="cpu")   # one rank survives here
        with pytest.raises(AssertionError, match="TP degree"):
            ElasticMesh().build(device="cpu")
    finally:
        release_mesh()


def test_preemption_guard_equals_the_reference():
    for cls in (PreemptionGuard, RF.PreemptionGuard):
        guard = cls()
        assert not guard.should_stop()
        guard.request_stop()
        assert guard.should_stop()
        guard = cls()
        guard._handler(signal.SIGTERM, None)  # what the SIGTERM hook calls
        assert guard.should_stop()
        assert cls(deadline_s=-1.0).should_stop()  # a deadline already past
        assert not cls(deadline_s=3600.0).should_stop()
