"""The pinned goldens, recomputed through the port alone.

``tests/data/golden_metrics.json`` freezes the headline numbers the docs
quote: the four fig12 mean-violation summaries (greedy vs lattice at 30 ms
and 50 ms SLO on the batch-saturating table) and the full ``ServingMetrics``
row of the fig4 lambda=140 cell. This file recomputes them with
``repro_torch`` only, at the reference's rtol=1e-9. The four fig14 cluster
rows are held the same way in ``tests/test_torch_cluster.py``.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro_torch.core import ProfileTable, SweepRunner, SweepSpec

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_metrics.json"
LAMBDAS = (20.0, 60.0, 100.0, 140.0, 180.0, 220.0, 240.0)


@pytest.fixture(scope="module")
def golden():
    with GOLDEN.open() as f:
        return json.load(f)


@pytest.mark.parametrize("policy,slo,quoted", [
    ("edgeserving", 0.030, "3.458%"),
    ("edgeserving-lattice", 0.030, "3.328%"),
    ("edgeserving", 0.050, "2.472%"),
    ("edgeserving-lattice", 0.050, "2.196%"),
])
def test_fig12_summary_pins(golden, policy, slo, quoted):
    entry = golden["fig12"][f"{policy}/slo{int(slo * 1e3)}ms"]
    assert entry["quoted"] == quoted

    runner = SweepRunner(ProfileTable.paper_rtx3080().with_batch_saturation(4))
    viols = [
        runner.run_cell(
            SweepSpec(policy=policy, rate=lam, slo=slo, seed=7, horizon=10.0)
        ).metrics.violation_ratio
        for lam in LAMBDAS
    ]
    np.testing.assert_allclose(viols, entry["per_lambda"], rtol=1e-9)
    mean = sum(viols) / len(viols)
    np.testing.assert_allclose(mean, entry["mean_violation_ratio"], rtol=1e-9)
    assert f"{mean * 100:.3f}%" == quoted


def test_fig4_lam140_cell(golden):
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    res = runner.run_cell(
        SweepSpec(policy="edgeserving", rate=140.0, seed=7, horizon=10.0))
    got = dataclasses.asdict(res.metrics)
    want = golden["fig4_lam140"]
    assert got.keys() == want.keys()
    for key in want:
        if key in ("per_model", "per_device"):
            assert len(got[key]) == len(want[key]), key
            for gm, wm in zip(got[key], want[key]):
                assert gm.keys() == wm.keys(), key
                for f in wm:
                    np.testing.assert_allclose(
                        gm[f], wm[f], rtol=1e-9, err_msg=f"{key}.{f}")
        else:
            np.testing.assert_allclose(
                got[key], want[key], rtol=1e-9, err_msg=key)
