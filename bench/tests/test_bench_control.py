"""The control at a size a test run holds: the plain reference computed
through float8 in the program's place has to fail the comparison that
the bfloat16 program passes, on three seeds (at the SMOKE sizes on the
CPU; the cells' own limits are set from readings on the card)."""

from __future__ import annotations

import json
import time

import pytest
import torch

from harness.cell import run_cell
from smallcfg import BENCH, small_config

# readings at this size: bfloat16 program token gap <= 0.013, lse gap
# <= 0.004, max gap <= 0.041; float8 control >= 0.32, >= 0.031 and >= 0.31
LIMITS = {"token_gap": 0.1, "lse_gap": 0.015, "max_gap": 0.12}


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_control_fails_where_the_program_passes(seed):
    traffic = json.loads((BENCH / "traffic" / "steady.json").read_text())
    rec = run_cell(small_config(dtype="bfloat16", limits=LIMITS), traffic,
                   seed, 0.6, False, torch.device("cpu"), time.perf_counter(),
                   control=True)
    assert rec.correct, rec.checks
    assert rec.control_correct is False, rec.control
