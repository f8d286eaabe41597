"""The port's entry points against the reference's on the CPU.

``repro_torch.launch.serve`` must print the reference CLI's lines for the
same argv. The quickstart's cells are run through ``run_experiment`` at a
2 s horizon against the reference's (the file itself runs 20 s).
"""

import ast
import dataclasses
import importlib.util
import pathlib
import sys

import pytest

import repro.core as R
import repro.launch.serve as ref_serve
import repro_torch.launch.serve as port_serve
from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    make_scheduler,
    paper_rate_vector,
    run_experiment,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _lines(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("argv", [
    ["--scheduler", "edgeserving", "--lam", "150", "--horizon", "2"],
    ["--all", "--horizon", "1"],
    ["--scheduler", "edgeserving-lattice", "--platform", "jetson",
     "--slo-ms", "80", "--lam", "40", "--horizon", "2", "--seed", "3"],
], ids=["edgeserving", "all", "lattice_jetson"])
def test_serve_prints_the_reference_lines(argv, monkeypatch, capsys):
    want = _lines(ref_serve.main, argv, monkeypatch, capsys)
    got = _lines(port_serve.main, argv, monkeypatch, capsys)
    assert len(want) == (8 if "--all" in argv else 1)
    assert got == want
    assert sorted(port_serve.PLATFORMS) == sorted(ref_serve.PLATFORMS)


def test_serve_rejects_an_unknown_scheduler_as_the_reference():
    with pytest.raises(ValueError) as want:
        ref_serve.one("nope", R.ProfileTable.paper_rtx3080(), 100.0, 0.05,
                      0.5, 0)
    with pytest.raises(ValueError) as got:
        port_serve.one("nope", ProfileTable.paper_rtx3080(), 100.0, 0.05,
                       0.5, 0)
    assert str(got.value) == str(want.value)


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples_torch" / "quickstart.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_quickstart_policies():
    tree = ast.parse((ROOT / "examples" / "quickstart.py").read_text())
    (loop,) = [n for n in ast.walk(tree) if isinstance(n, ast.For)]
    return tuple(ast.literal_eval(loop.iter))


@pytest.mark.parametrize("policy", _reference_quickstart_policies())
def test_quickstart_cells_equal_the_reference(policy):
    assert _quickstart().POLICIES == _reference_quickstart_policies()
    got = run_experiment(
        make_scheduler(policy, ProfileTable.paper_rtx3080(),
                       SchedulerConfig(slo=0.050, max_batch=10)),
        ProfileTable.paper_rtx3080(), paper_rate_vector(200), horizon=2.0,
        seed=0)
    want = R.run_experiment(
        R.make_scheduler(policy, R.ProfileTable.paper_rtx3080(),
                         R.SchedulerConfig(slo=0.050, max_batch=10)),
        R.ProfileTable.paper_rtx3080(), R.paper_rate_vector(200),
        horizon=2.0, seed=0)
    assert dataclasses.asdict(got.metrics) == dataclasses.asdict(want.metrics)
