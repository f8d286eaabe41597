"""The harness loads neither JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and
without a card it exits non-zero and prints no result."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from smallcfg import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in path.read_text(), path


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("PYTHONPATH", None)
    return env


def test_loaded_modules():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness.cell, harness.check, reference.lm, costs.model\n"
        "import run\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
        % (str(BENCH.parent / "src"), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env())
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_without_a_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "dense_pair.steady", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, env=_env(),
        cwd=BENCH.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
