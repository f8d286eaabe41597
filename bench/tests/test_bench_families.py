"""A model family beyond ``dense`` and ``encdec`` is found by its name
under ``bench/families/``: the reference, the costs and the implied
launches all refer its models to that file, and a family with no file is
refused."""

from __future__ import annotations

import sys
import types

import pytest

import families
from costs.kernels import quantum_calls
from costs.model import quantum_flops
from harness import launches
from reference import lm as ref_lm


@pytest.fixture
def toy_family(monkeypatch):
    mod = types.ModuleType("families.toy")
    mod.quantum_launches = lambda lm, e: {"rmsnorm": 7 * (e + 1),
                                          "flash_attention": 0,
                                          "exit_head": 1}
    mod.quantum_calls = lambda lm, e, b, s: [("exit_head", (b, 4, 9))]
    mod.quantum_flops = lambda lm, e, b, s: 123.0 * b
    mod.exit_logits = lambda weights, lm, tokens, exits, src=None, \
        fp8=False: ["toy", fp8]
    monkeypatch.setitem(sys.modules, "families.toy", mod)
    return {"family": "toy", "exits": [1, 2]}


def test_a_family_file_serves_every_part(toy_family):
    lm = toy_family
    assert launches.quantum_launches(lm, 1)["rmsnorm"] == 14
    assert launches.implied([lm], [(0, 0), (0, 1)], 2) == {
        "rmsnorm": 21, "flash_attention": 0, "exit_head": 2,
        "stability_score": 2}
    assert quantum_calls(lm, 0, 3, 16) == [("exit_head", (3, 4, 9))]
    assert quantum_flops(lm, 0, 2, 16) == 246.0
    assert ref_lm.exit_logits({}, lm, None, [0], fp8=True) == ["toy", True]


@pytest.mark.parametrize("name", ["nosuchfamily", "../run", "a.b"])
def test_a_family_without_a_file_is_refused(name):
    with pytest.raises(ValueError):
        families.module(name)
    with pytest.raises(ValueError):
        launches.quantum_launches({"family": name, "exits": [1]}, 0)
