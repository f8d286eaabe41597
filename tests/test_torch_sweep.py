"""The port's sweep harness against the JAX reference's on the CPU.

A cell is fully determined by (runner, spec), so the port's ``run_cell``
must give the reference's ``ServingMetrics`` with ``==``, and a grid run in
two spawned workers must equal the serial run bitwise, in grid order.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from torch_compare import plain
from repro_torch.core import (
    AdaptConfig,
    ProfileTable,
    ScanEngineUnsupported,
    SweepRunner,
    SweepSpec,
)

SMALL = dict(horizon=1.0, warmup_tasks=20, device="cpu")


def _plain(metrics):
    """``ServingMetrics`` as a dict; the reference's ``per_device`` is a
    tuple of its own ``DeviceMetrics``, empty for a single device."""
    return dataclasses.asdict(metrics)


def _ref_spec(spec):
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(R.SweepSpec)}
    if spec.adapt is not None:
        fields["adapt"] = R.AdaptConfig(**dataclasses.asdict(spec.adapt))
    return R.SweepSpec(**fields)


def test_spec_fields_are_the_reference_ones_and_a_device():
    want = [(f.name, f.default) for f in dataclasses.fields(R.SweepSpec)]
    got = [(f.name, f.default) for f in dataclasses.fields(SweepSpec)]
    assert got == want + [("device", None)]


@pytest.mark.parametrize("kwargs", [
    dict(policy="edgeserving"),
    dict(policy="edgeserving-lattice", backend="cuda", rate=240.0, seed=3),
    dict(policy="edgeserving", backend="torch", scenario="mmpp", rate=12.5),
    dict(policy="symphony", drift="contention", adapt=AdaptConfig()),
    dict(policy="all-final", drift="none"),
    dict(policy="edgeserving", label="custom title"),
    dict(policy="edgeserving", fleet="heterogeneous", fleet_size=4,
         dispatcher="round-robin"),
    dict(policy="edgeserving", engine="scan"),
])
def test_titles_equal_the_reference(kwargs):
    spec = SweepSpec(**kwargs)
    assert spec.title() == _ref_spec(spec).title()
    assert spec.rate_vector() == _ref_spec(spec).rate_vector()
    assert hash(spec) == hash(SweepSpec(**kwargs))


def _grid(runner):
    specs = runner.grid(
        policies=("edgeserving", "edgeserving-lattice", "symphony"),
        scenarios=("poisson", "mmpp", "flash-crowd"),
        rates=(100.0, 200.0), seeds=(7,), **SMALL)
    specs += [
        SweepSpec(policy="edgeserving", scenario="diurnal", rate=180.0,
                  slo=0.030, deadlines=(0.03, 0.05, 0.08),
                  scenario_kwargs=(("period", 0.5),), **SMALL),
        SweepSpec(policy="edgeserving-lattice", scenario="trace-replay",
                  rate=160.0, drift="thermal-throttle",
                  drift_kwargs=(("onset", 0.2), ("ramp", 0.5)),
                  adapt=AdaptConfig(refresh_every=0.1), **SMALL),
        SweepSpec(policy="earlyexit-edf", rates=(90.0, 60.0, 30.0),
                  max_batch=4, **SMALL),
    ]
    return specs


def test_run_cell_equals_the_reference():
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    ref_runner = R.SweepRunner(R.ProfileTable.paper_rtx3080())
    specs = _grid(runner)
    want_specs = ref_runner.grid(
        policies=("edgeserving", "edgeserving-lattice", "symphony"),
        scenarios=("poisson", "mmpp", "flash-crowd"),
        rates=(100.0, 200.0), seeds=(7,), horizon=1.0, warmup_tasks=20)
    assert [_ref_spec(s) for s in specs[:len(want_specs)]] == want_specs
    for spec in specs:
        got = runner.run_cell(spec)
        want = ref_runner.run_cell(_ref_spec(spec))
        assert got.spec == spec and got.trace is None
        assert _plain(got.metrics) == _plain(want.metrics), spec.title()


def test_runner_views_equal_the_reference():
    """A restricted scheduler table, a deployment map and service noise
    ride on the runner, as in the reference."""
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    kwargs = dict(model_map=(2, 0, 1), service_noise_cov=0.03, data_pool=64)
    runner = SweepRunner(table, sched_table=table.with_safety(1.2), **kwargs)
    ref_runner = R.SweepRunner(ref_table,
                               sched_table=ref_table.with_safety(1.2),
                               **kwargs)
    for policy in ("edgeserving", "earlyexit-lqf"):
        spec = SweepSpec(policy=policy, rate=150.0, **SMALL)
        assert (_plain(runner.run_cell(spec).metrics)
                == _plain(ref_runner.run_cell(_ref_spec(spec)).metrics))


def test_two_workers_equal_serial_bitwise_in_grid_order():
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    specs = [
        SweepSpec(policy="edgeserving", rate=200.0, **SMALL),
        SweepSpec(policy="edgeserving-lattice", scenario="mmpp",
                  backend="cuda", **SMALL),
        SweepSpec(policy="symphony", rate=240.0, **SMALL),
        SweepSpec(policy="edgeserving", backend="torch", drift="dvfs-step",
                  adapt=AdaptConfig(refresh_every=0.2), **SMALL),
    ]
    serial = runner.run(specs, workers=1)
    parallel = runner.run(specs, workers=2)
    assert [r.spec for r in parallel] == specs
    assert ([_plain(r.metrics) for r in parallel]
            == [_plain(r.metrics) for r in serial])
    assert runner.run([], workers=2) == []


@pytest.mark.parametrize("kwargs", [
    dict(engine="scan", fleet="homogeneous"),
    dict(engine="scan"),
    dict(engine="scan", trace=True),
])
def test_tiers_not_ported_raise(kwargs):
    """The compiled scan tier's cells, single-device, fleet and traced,
    give the reference's sweep cell: the same metrics and, traced, the same
    timeline apart from each decision's score and margin (ulp-level, held
    at rtol 1e-9 and atol 1e-12). The reference rejects a traced fleet
    cell; so does the port, with the same error. (The name is historical:
    these cases raised while the tier was not ported.)"""
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    ref_runner = R.SweepRunner(R.ProfileTable.paper_rtx3080())
    spec = SweepSpec(policy="edgeserving", rate=140.0, **kwargs, **SMALL)
    got = runner.run_cell(spec)
    want = ref_runner.run_cell(_ref_spec(spec))
    assert got.spec == spec
    assert _plain(got.metrics) == _plain(want.metrics), spec.title()
    assert got.metrics == runner.run_cell(
        dataclasses.replace(spec, engine="python")).metrics
    if spec.trace:
        assert got.trace.meta == want.trace.meta
        assert plain(got.trace.spans) == plain(want.trace.spans)
        assert len(got.trace.decisions) == len(want.trace.decisions)
        for g, w in zip(got.trace.decisions, want.trace.decisions):
            gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
            for f in ("score", "margin"):
                np.testing.assert_allclose(gd.pop(f), wd.pop(f), rtol=1e-9,
                                           atol=1e-12)
            assert gd == wd
        fleet = dataclasses.replace(spec, fleet="homogeneous", fleet_size=2)
        with pytest.raises(R.ScanEngineUnsupported) as ref_err:
            ref_runner.run_cell(_ref_spec(fleet))
        with pytest.raises(ScanEngineUnsupported) as err:
            runner.run_cell(fleet)
        assert str(err.value) == str(ref_err.value).replace(
            "documented loud-reject; see docs/simulator.md",
            "a documented loud reject")
    else:
        assert got.trace is None and want.trace is None


def test_cluster_grid_and_bad_fields_raise():
    """``cluster_grid`` builds the reference's grid; the reference's
    errors for contradictory specs stay: cluster-only fields on a
    single-device cell, an unknown engine, and a runner-level view on a
    fleet cell."""
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    grid = runner.cluster_grid(("least-loaded", "jsq"),
                               (("homogeneous", 2), ("heterogeneous", 4)),
                               rates=(100.0, 200.0))
    ref = R.SweepRunner(R.ProfileTable.paper_rtx3080()).cluster_grid(
        ("least-loaded", "jsq"), (("homogeneous", 2), ("heterogeneous", 4)),
        rates=(100.0, 200.0))
    assert [_ref_spec(s) for s in grid] == ref
    for kwargs in (dict(fleet_size=2), dict(fail_at=((0, 1.0),)),
                   dict(dispatcher="round-robin"), dict(engine="jit")):
        with pytest.raises(ValueError):
            runner.run_cell(SweepSpec(policy="edgeserving", **kwargs,
                                      **SMALL))
    viewed = SweepRunner(ProfileTable.paper_rtx3080(), model_map=(0, 1, 2))
    with pytest.raises(NotImplementedError, match="per-device schedulers"):
        viewed.run_cell(SweepSpec(policy="edgeserving", fleet="homogeneous",
                                  fleet_size=2, **SMALL))
