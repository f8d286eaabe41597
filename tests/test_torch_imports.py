"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and not the port's measurement script
``tools/scoring_round_split.py`` imports JAX or the reference package
``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_package_is_present():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    for module in ("core/request.py", "core/profile.py", "core/queues.py",
                   "core/urgency.py", "kernels/stability_score/ops.py",
                   "kernels/stability_score/ref.py", "core/scoring.py",
                   "core/scheduler.py", "core/baselines.py",
                   "core/workloads.py", "core/traffic.py", "core/metrics.py",
                   "models/common.py", "models/resnet.py",
                   "configs/edgeserving_resnets.py", "runtime/server.py",
                   "models/convert.py"):
        assert module in names, module
    assert (ROOT / "src" / "repro_torch" / "csrc" / "stability_score.cu").exists()


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py",
                          ROOT / "tools" / "scoring_round_split.py"],
    ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom repro.core import urgency\n"
                     "import jax.numpy as jnp\n")
    assert [m for m, _ in _imported_roots(probe)] == ["os", "repro", "jax"]
