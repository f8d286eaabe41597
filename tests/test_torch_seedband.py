"""The port's seed bands against the reference's on the CPU.

``repro_torch.core.seedband`` puts confidence bands on per-seed metric
columns from the compiled scans. Its statistics are host numpy, op for op
the reference's, so on fixed inputs they are equal with ``==``; its columns
must not depend on how the seeds are chunked into lanes; and fig17's smoke
grid cells (``REPRO_FIG17_SMOKE``: lambda in {100, 220} at 8 seeds over
2 s) give the reference's columns. The smoke fleet cell is in
``tests/test_torch_seedband_fleet.py``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    compare_bands,
    make_fleet,
    make_scenario,
    make_scheduler,
    paper_rate_vector,
    simulate_cluster_scan,
    simulate_cluster_scan_seedband,
    simulate_scan_seedband,
    summarize_band,
)
from repro_torch.core import seedband

def _plain(band):
    return [dataclasses.asdict(m) for m in band.metrics]


def _columns():
    rng = np.random.default_rng(7)
    return {
        "normal": rng.normal(3.0, 0.5, size=501),
        "exponential": rng.exponential(2.0, size=501),
        "bimodal": np.concatenate([rng.normal(0.0, 0.1, 250),
                                   rng.normal(5.0, 0.1, 251)]),
        "single": np.array([0.25]),
        "pair": np.array([1.0, 2.0]),
    }


@pytest.mark.parametrize("level", [0.80, 0.95, 0.99])
@pytest.mark.parametrize("name", sorted(_columns()))
def test_summarize_band_equals_the_reference(name, level):
    col = _columns()[name]
    got = summarize_band(col, level=level)
    want = R.summarize_band(col, level=level)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert str(got) == str(want)
    assert seedband._z_for_level(level) == R.seedband._z_for_level(level)


@pytest.mark.parametrize("shift", [0.0, 0.005, 0.15])
def test_compare_bands_equals_the_reference(shift):
    rng = np.random.default_rng(3)
    a = rng.normal(0.10 + shift, 0.02, 400)
    b = rng.normal(0.10, 0.02, 300)
    got, want = compare_bands(a, b), R.compare_bands(a, b)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert str(got) == str(want)


def test_bad_inputs_raise_as_the_reference_does():
    for fn, ref_fn, args in (
        (summarize_band, R.summarize_band, ([],)),
        (summarize_band, R.summarize_band, (np.zeros((3, 3)),)),
        (summarize_band, R.summarize_band, ([1.0, 2.0], 1.5)),
        (compare_bands, R.compare_bands, ([1.0], [1.0, 2.0])),
    ):
        with pytest.raises(ValueError):
            ref_fn(*args)
        with pytest.raises(ValueError):
            fn(*args)
    table = ProfileTable.paper_rtx3080()
    proc = make_scenario("poisson", paper_rate_vector(100.0))
    with pytest.raises(ValueError):
        simulate_scan_seedband(
            make_scheduler("edgeserving", table, SchedulerConfig()), table,
            proc, 0.5, range(2), chunk=0, device="cpu")


def test_columns_do_not_change_with_chunk_size():
    table = ProfileTable.paper_rtx3080().with_batch_saturation(4)
    sched = make_scheduler("edgeserving", table, SchedulerConfig(slo=0.05))
    proc = make_scenario("poisson", paper_rate_vector(120.0))
    args = (sched, table, proc, 0.8, range(7))
    whole = simulate_scan_seedband(*args, chunk=7, device="cpu")
    single = simulate_scan_seedband(*args, chunk=1, device="cpu")
    uneven = simulate_scan_seedband(*args, chunk=3, device="cpu")
    assert whole.metrics == single.metrics == uneven.metrics
    assert np.array_equal(whole.column("p95_latency"),
                          uneven.column("p95_latency"))
    fleet = make_fleet("homogeneous", 2, table)
    kw = dict(dispatcher="jsq", device="cpu")
    a = simulate_cluster_scan_seedband(fleet, proc, 0.6, range(4), chunk=4,
                                       **kw)
    b = simulate_cluster_scan_seedband(fleet, proc, 0.6, range(4), chunk=3,
                                       **kw)
    assert a.metrics == b.metrics
    for seed, got in zip(a.seeds, a.metrics):
        one = simulate_cluster_scan(fleet, proc.generate(0.6, seed=seed),
                                    0.6, keep_completions=False, **kw)
        assert got == one.metrics


@pytest.mark.parametrize("lam", [100.0, 220.0])
def test_fig17_smoke_grid_band_equals_the_reference(lam):
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    got = simulate_scan_seedband(
        make_scheduler("edgeserving", table, SchedulerConfig(slo=0.05)),
        table, make_scenario("poisson", paper_rate_vector(lam)), 2.0,
        range(8), chunk=4, device="cpu")
    want = R.simulate_scan_seedband(
        R.make_scheduler("edgeserving", ref_table,
                         R.SchedulerConfig(slo=0.05)),
        ref_table, R.make_scenario("poisson", R.paper_rate_vector(lam)), 2.0,
        range(8), chunk=4)
    assert got.seeds == want.seeds
    assert _plain(got) == _plain(want)
    for field in ("violation_ratio", "p95_latency"):
        assert dataclasses.astuple(got.band(field)) == \
            dataclasses.astuple(want.band(field))


@pytest.mark.parametrize("failing", [False, True])
def test_split_seconds_name_every_part_of_a_band(failing):
    """``simfast.split_seconds`` sums each part of the scan entry points' host
    time: a grid band fills generate / plan / steps / rollup, a fleet band
    also parse, and a fleet with a failing device fail-over."""
    from repro_torch.core.simfast import split_seconds

    table = ProfileTable.paper_rtx3080()
    cfg = SchedulerConfig()
    proc = make_scenario("poisson", paper_rate_vector(100.0))
    split_seconds.clear()
    simulate_scan_seedband(make_scheduler("edgeserving", table, cfg), table,
                           proc, 0.3, range(2), device="cpu")
    grid = dict(split_seconds)
    assert set(grid) == {"generate", "plan", "steps", "rollup"}
    split_seconds.clear()
    fleet = make_fleet("heterogeneous", 2, table,
                       fail_at=((1, 0.15),) if failing else ())
    simulate_cluster_scan_seedband(fleet, proc, 0.3, range(2),
                                   dispatcher="jsq", device="cpu")
    parts = {"generate", "plan", "steps", "parse", "rollup"}
    assert set(split_seconds) == parts | ({"fail-over"} if failing else set())
    assert all(v > 0.0 for v in list(grid.values())
               + list(split_seconds.values()))
