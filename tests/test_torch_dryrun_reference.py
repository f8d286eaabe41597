"""The port's dry-run counts (``launch/dryrun.py::lower_cell``) held
against the reference's on the same depth-cut cells of both production
meshes, (16, 16) and (2, 16, 16): every width and shape FULL, two layers
(two exits).

The reference runs in a subprocess: ``repro/launch/dryrun.py`` sets
``XLA_FLAGS`` for 512 host devices before JAX starts, and XLA partitions
and compiles each cell. The port runs the step eagerly over ``DTensor``s
and partitions it by ``launch/graph_analysis.py``'s rules. The two
partitioners need not agree op for op, so the bounds are these:

* flops a device: equal, the train cell's too (its partition is XLA's:
  the batch replicated by the FSDP-sharded table's lookup, the attention
  on every row and each device's heads, its backward XLA's four products;
  see ``tests/test_torch_dryrun_reference_train.py``);
* collective bytes a device: within a factor of 4 either way (the two
  reduce partial sums at different ops);
* static bytes a device: equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, release_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 2
# (arch, shape, mesh) -> the band of port flops / reference flops
CELLS = {
    ("qwen3-8b", "train_4k", "single"): (1.0, 1.0),
    ("qwen3-8b", "prefill_32k", "single"): (1.0, 1.0),
    ("qwen3-8b", "decode_32k", "single"): (1.0, 1.0),
    ("smollm-135m", "prefill_32k", "single"): (1.0, 1.0),
    ("qwen3-8b", "prefill_32k", "multi"): (1.0, 1.0),
    ("qwen3-8b", "decode_32k", "multi"): (1.0, 1.0),
}
COLLECTIVE_BAND = (0.25, 4.0)
IDS = ["-".join(c) for c in CELLS]

_REFERENCE = """
import json, sys
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
n = int(sys.argv[1])
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for cell in sys.argv[2:]:
        arch, shape, name = cell.split(":")
        if (name == "multi") != multi:
            continue
        rec = dryrun.lower_cell(arch, shape, mesh, multi, overrides={
            "num_layers": n, "exits": (n // 2, n)})
        out[cell] = {"flops": rec["hlo_metrics"]["flops"],
                     "collective_bytes": rec["collectives"]["bytes"]["total"],
                     "static": rec["bytes_per_device_static"]}
print(json.dumps(out))
"""


def _cut():
    return {"num_layers": LAYERS, "exits": (LAYERS // 2, LAYERS)}


@pytest.fixture(scope="module")
def reference():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(LAYERS)]
        + [":".join(c) for c in CELLS],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    recs = {}
    for multi in (False, True):
        release_mesh()
        mesh = make_production_mesh(multi_pod=multi)
        try:
            for a, s, name in CELLS:
                if (name == "multi") != multi:
                    continue
                rec = dryrun.lower_cell(a, s, mesh, multi, overrides=_cut())
                recs[f"{a}:{s}:{name}"] = {
                    "flops": rec["hlo_metrics"]["flops"],
                    "collective_bytes": rec["collectives"]["bytes"]["total"],
                    "static": rec["bytes_per_device_static"]}
        finally:
            release_mesh()
    return recs


@pytest.mark.parametrize("cell", list(CELLS), ids=IDS)
def test_flops_per_device_against_the_reference(reference, port, cell):
    key = ":".join(cell)
    lo, hi = CELLS[cell]
    ratio = port[key]["flops"] / reference[key]["flops"]
    assert lo * (1 - 1e-9) <= ratio <= hi * (1 + 1e-9), ratio


@pytest.mark.parametrize("cell", list(CELLS), ids=IDS)
def test_collective_bytes_against_the_reference(reference, port, cell):
    key = ":".join(cell)
    ratio = (port[key]["collective_bytes"]
             / reference[key]["collective_bytes"])
    assert COLLECTIVE_BAND[0] <= ratio <= COLLECTIVE_BAND[1], ratio


@pytest.mark.parametrize("cell", list(CELLS), ids=IDS)
def test_static_bytes_equal_the_references(reference, port, cell):
    key = ":".join(cell)
    assert port[key]["static"] == reference[key]["static"]
