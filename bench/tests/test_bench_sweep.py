"""The sweep's rule for the knee (``bench/sweep.py``) on the two sweeps
that set the configurations' ``knee_req_s``: (rate, share of requests in
time, largest queue at the end), one list per seed, as measured on an
NVIDIA H100 80GB HBM3 (700 W) with 12 s windows, seeds 7 and 8."""

from __future__ import annotations

import json

import pytest

import sweep
from smallcfg import BENCH

DENSE = (
    [(300, 0.9864, 2), (350, 0.9774, 2), (400, 0.971, 3), (450, 0.978, 3),
     (500, 0.9935, 2), (550, 0.9874, 5), (600, 0.9903, 8), (650, 0.9659, 11),
     (700, 0.9896, 14)],
    [(300, 0.9722, 3), (350, 0.9464, 8), (400, 0.9423, 4), (450, 0.9507, 5),
     (500, 0.9392, 6), (550, 0.9367, 7), (600, 0.9322, 14), (650, 0.8362, 8),
     (700, 0.9498, 3)],
)
SPEECH = (
    [(150, 0.9494, 3), (175, 0.97, 3), (200, 0.9679, 2), (225, 0.9678, 4),
     (250, 0.9533, 6), (275, 0.9324, 5)],
    [(150, 0.9628, 4), (175, 0.9752, 4), (200, 0.9775, 3), (225, 0.9659, 7),
     (250, 0.9263, 8), (275, 0.8715, 4)],
)


def _sweeps(table):
    return [[{"rate_req_s": float(r), "met_share": m, "queues_at_end": [q, 0]}
             for r, m, q in rows] for rows in table]


@pytest.mark.parametrize("name,table", [("dense_pair", DENSE),
                                        ("speech_pair", SPEECH)])
def test_rule_gives_the_committed_knee(name, table):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    got = sweep.knee(_sweeps(table), config["max_batch"])
    assert got == config["knee_req_s"]


@pytest.mark.parametrize("table", (DENSE, SPEECH), ids=("dense", "speech"))
def test_no_rate_holds_99_percent_in_both_sweeps(table):
    assert sweep.knee(_sweeps(table), 8, min_share=0.99) is None


def test_a_rate_missing_from_a_sweep_ends_the_knee():
    a, b = _sweeps(DENSE)
    assert sweep.knee([a, b[:3]], 8) == 400.0
