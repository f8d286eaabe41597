"""fig17's smoke fleet cell through the port's seed band, against the
reference's, on the CPU: the heterogeneous fleet of 4 (2 fast, 2
Jetson-class) under MMPP at lambda_152 = 640, 6 seeds over 1.5 s, ring
width 128, with stability-aware (as a full scan) and JSQ dispatch. The
per-seed columns, and the JSQ-minus-stability-aware gap, are the
reference's with ``==``.
"""

import dataclasses

import pytest

import repro.core as R
from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    compare_bands,
    make_fleet,
    make_scenario,
    paper_rate_vector,
    simulate_cluster_scan_seedband,
)

FLEET_LAM = 160.0 * 4
FLEET_SIZE = 4
HORIZON = 1.5


@pytest.fixture(scope="module")
def columns():
    """Each dispatcher's port and reference violation columns."""
    return {}


@pytest.mark.parametrize("disp", ["stability-aware", "jsq"])
def test_fig17_smoke_fleet_band_equals_the_reference(disp, columns):
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    proc = make_scenario("mmpp", paper_rate_vector(FLEET_LAM))
    ref_proc = R.make_scenario("mmpp", R.paper_rate_vector(FLEET_LAM))
    # fig17 groups seeds by arrival count so a chunk's lanes pad alike
    seeds = sorted(range(6), key=lambda s: len(
        proc.generate_columns(HORIZON, seed=s)))
    got = simulate_cluster_scan_seedband(
        make_fleet("heterogeneous", FLEET_SIZE, table), proc, HORIZON, seeds,
        chunk=3, dispatcher=disp, power_d=FLEET_SIZE,
        config=SchedulerConfig(slo=0.05), max_queue=128, device="cpu")
    want = R.simulate_cluster_scan_seedband(
        R.make_fleet("heterogeneous", FLEET_SIZE, ref_table), ref_proc,
        HORIZON, seeds, chunk=3, dispatcher=disp, power_d=FLEET_SIZE,
        config=R.SchedulerConfig(slo=0.05), max_queue=128)
    assert got.seeds == want.seeds
    assert [dataclasses.asdict(m) for m in got.metrics] == \
        [dataclasses.asdict(m) for m in want.metrics]
    columns[disp] = (got.column("violation_ratio"),
                     want.column("violation_ratio"))
    if len(columns) == 2:
        gap = compare_bands(columns["jsq"][0], columns["stability-aware"][0])
        ref_gap = R.compare_bands(columns["jsq"][1],
                                  columns["stability-aware"][1])
        assert dataclasses.astuple(gap) == dataclasses.astuple(ref_gap)
