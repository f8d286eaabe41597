"""The port's dry-run (``launch/dryrun.py``) against the reference's on the
CPU: ``--list`` prints the reference's 40 rows (8 skipped, with the same
reasons); a record has the reference's keys; a cell lowers end to end
through the CLI into ``artifacts/dryrun_torch`` (never the reference's
``artifacts/dryrun``, which ``tests/test_artifacts.py`` reads); a cut
train cell on the production mesh counts a forward, backward and
optimizer step per device, and an error becomes an ``"error"`` record."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, release_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}


def reference_record_keys():
    """The keys of the dict ``repro/launch/dryrun.py::lower_cell`` returns,
    read from its source (lowering it needs 256 devices)."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


def _list(module):
    out = subprocess.run([sys.executable, "-m", module, "--list"], env=ENV,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.splitlines()


def test_list_prints_the_references_rows():
    port = _list("repro_torch.launch.dryrun")
    assert port == _list("repro.launch.dryrun")
    assert len(port) == 40
    skipped = [row for row in port if "sub-quadratic" in row]
    assert len(skipped) == 8


def test_default_output_is_not_the_references():
    assert dryrun.DEFAULT_OUT == "artifacts/dryrun_torch"
    assert "artifacts/dryrun_torch/" in (ROOT / ".gitignore").read_text()


def test_cli_lowers_one_cell_into_its_own_folder(tmp_path):
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "smollm-135m", "--shape", "prefill_32k",
                    "--mesh", "single"],
                   env=ENV, cwd=tmp_path, capture_output=True, text=True,
                   timeout=300, check=True)
    assert not (tmp_path / "artifacts" / "dryrun").exists()
    rec = json.loads((tmp_path / "artifacts" / "dryrun_torch" / "single" /
                      "smollm-135m__prefill_32k.json").read_text())
    assert set(rec) == reference_record_keys()
    assert rec["num_devices"] == 256 and rec["mesh"] == [16, 16]
    assert rec["mesh_axes"] == ["data", "model"] and rec["rules"] == "serve"
    assert rec["hlo_metrics"]["flops"] > 0
    assert rec["cost_analysis"]["flops"] == rec["hlo_metrics"]["flops"]


@pytest.fixture
def mesh():
    release_mesh()
    yield make_production_mesh()
    release_mesh()


def _cut(layers=2):
    """Depth cut to ``layers`` (two exits), every width and shape FULL: a
    shape-only run costs the same at any batch or sequence length."""
    return {"num_layers": layers, "exits": (layers // 2, layers)}


def test_cut_train_cell_on_the_production_mesh(mesh):
    rec = dryrun.lower_cell("qwen3-8b", "train_4k", mesh, False,
                            overrides=_cut())
    assert set(rec) == reference_record_keys()
    assert rec["kind"] == "train" and rec["rules"] == "train-fsdp"
    assert rec["overrides"] == _cut()
    flops = rec["hlo_metrics"]["flops"]
    # forward + backward at least 6 N D over the devices (and each exit's
    # head); replicated work can only add to it
    assert flops * 256 >= rec["model_flops"]
    assert rec["collectives"]["bytes"]["total"] > 0
    assert rec["bytes_per_device_static"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] == (
        rec["bytes_per_device_static"])


@pytest.mark.parametrize("arch,shape,layers", [
    ("qwen3-8b", "prefill_32k", 2), ("deepseek-moe-16b", "decode_32k", 4)])
def test_cut_serve_cells(mesh, arch, shape, layers):
    rec = dryrun.lower_cell(arch, shape, mesh, False, overrides=_cut(layers))
    assert rec["kind"] == SHAPES[shape].kind and rec["rules"] == "serve"
    assert 0 < rec["hlo_metrics"]["flops"] * 256 < 64 * rec["model_flops"]


def test_a_failing_cell_writes_an_error_record(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("no sharding rule")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    rc = dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--mesh",
                      "single", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "single" /
                      "qwen3-8b__train_4k.json").read_text())
    assert "no sharding rule" in rec["error"]
    release_mesh()


def test_rwkv6_shift_is_the_padded_shift():
    """``_shifted`` (a zero row, then every row but the last) gives
    ``F.pad``'s bits, which it replaced so that the dry-run's DTensors
    lower it."""
    import torch.nn.functional as F

    from repro_torch.models.rwkv6 import _shifted

    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1, 2, 17):
            x = torch.randn(3, s, 8, generator=gen).to(dtype)
            want = F.pad(x, (0, 0, 1, 0))[:, :-1]
            got = _shifted(x, None)
            assert got.dtype == dtype and torch.equal(got, want)


def test_cut_rwkv6_prefill_cell_lowers(mesh, monkeypatch):
    """RWKV6's prefill cell, cut to 2 layers and 128 tokens, lowers on the
    (16, 16) mesh to a record with no error. Its token shift, written with
    ``F.pad``, stopped DTensor's propagation with an IndexError on torch
    2.11; torch 2.13 lowered that form too, so under 2.13 this test holds
    the cell but not the repair, which only a 2.11 run shows."""
    import dataclasses

    monkeypatch.setitem(SHAPES, "prefill_32k", dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=128))
    rec = dryrun.lower_cell("rwkv6-1.6b", "prefill_32k", mesh, False,
                            overrides=_cut())
    assert "error" not in rec
    assert rec["kind"] == "prefill" and rec["hlo_metrics"]["flops"] > 0
