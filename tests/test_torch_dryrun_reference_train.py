"""The port's dry-run train cells (``launch/dryrun.py::lower_cell``, one
forward, backward and optimizer step) held against the reference's
``lower_cell``: flops, collective bytes and static bytes a device.

Cells: the six families' ``train_4k`` on the (16, 16) mesh, each cut to
two layers with every width FULL (the overrides of
``tests/test_torch_dryrun_reference_zoo.py``: Jamba ``attn_period`` 2 and
``attn_offset`` 1, V3 ``dense_prefix`` 1, exits (2,) for Jamba, V3 and
DeepSeek-MoE, (1, 2) for the rest; Seamless keeps its 24-layer encoder,
which ``num_layers`` does not cut); Qwen3, V3, RWKV6 and SmolLM on (2, 16,
16); and
Qwen3 at full depth on (16, 16), flops only, whose reference count
``chip_smoke.py`` records as ``COST_REFERENCE_FLOPS`` for the card
machine, which has no JAX. The reference runs in two subprocesses (one a
mesh, its 512 host devices set in ``XLA_FLAGS`` before JAX starts) while
the port counts its cells.

What the counts showed, family by family (``tools/dryrun_diff.py``
prints both sides op by op), and the rules of
``launch/graph_analysis.py`` that now follow XLA:

* every family: the train rules shard the embedding table's embedding
  dimension over "data"; XLA keeps the table in place and gathers the
  token indices, so the whole step runs on every batch row with the
  embedding split on "data" (the reference's products have 1 048 576
  rows). The counter's lookup now does the same (``_lookup``; its
  backward, ``_rows_added``, adds every row into each device's slice);
* Qwen3 (0.686 at two layers, 0.455 at 36): the attention then runs on
  all 256 rows and each device's two query heads, sixteen times the
  batch-split attention billed before. Its backward is billed as XLA's
  autodiff computes it: four products, no recompute of the scores (XLA
  keeps the probabilities; the kernel recomputes them) and dv on half
  its columns where two devices share a kv head. The kv projections'
  weight gradient runs on each device's 64 columns (a reshape that had to
  gather keeps XLA's tiling on the way back); the cross-entropy runs on
  the logits' own shards (``_cross_entropy_partition``: torch 2.11's
  ``DTensor`` left the gather's backward, and with it the unembedding's
  weight gradient, whole on every device of "model", 1.458x the reference
  at full depth on the card machine); the RMSNorm backward takes each
  gradient on its input's sharding. Heads that do not divide the axis
  (Phi-4-mini's 24, StarCoder2's 36; not held here, but checked with the
  tool) are tiled as XLA tiles them, heads over gcd(16, K) and the head
  dim over the rest, the value products on the head dim's share;
* DeepSeek-MoE (0.479): the four MoE einsums run on each device's
  experts (``models/moe.py::_experts`` by ``_moe_partition``), every
  group, the embedding split, the gate and up products all-reduced;
* DeepSeek-V3 (0.662): MLA and the MoE on local shards, with gradients:
  the MLA and WKV rules took ``_local_tensor``, which carries none, so
  their backward was not billed at all;
* Jamba (1.078): XLA's remat "dots" keeps every product, so the dry-run
  builds the model with remat "none" (the port's checkpoint recomputed
  the superblock); Mamba's
  in-projection split into x and z keeps its sharding (``_split_sharded``,
  ``_cat_sharded``), the time loop's backward is billed S trips as its
  forward is, and a product that contracts a dimension of size 1 (the
  scan's outer product) bills no flops, as XLA's simplifier makes it a
  multiply;
* Seamless (0.219): the decoder's layer loop keeps one sharding for its
  carry (``_layer_partition``; the cross-attention had left the stream
  batch-sharded after the first block), the cross-attention runs on the
  encoder's rows and the heads (``_cross_partition``), and the 256 206-wide
  unembedding, whose vocabulary does not divide 16, is partitioned as XLA
  partitions it (``_unembed_partition``): rows over "model", the logits
  moved onto "data" by a collective-permute, and h's gradient computed
  with the whole table for each device's rows on every device of "data"
  (6.88e13 flops a device, 76% of the cell);
* RWKV6 (0.739): the counted trip of the WKV time loop read the state
  before the decay updated it, so no gradient reached the decay and its
  LoRA's backward went unbilled; it now reads the updated state, as every
  trip but the first does. The static bytes were 245 760 short: the
  optimizer states of a block's ``[D]`` vectors took the exit norm's
  "data" spec, where the reference's stacked ``[1, D]`` vectors take the
  first block vector's (``runtime/trainer.py::stacked_layers``). Two of
  each block's ``[D, D]`` products are still split apart, not repaired,
  and the cells are held phase by phase (``SPLIT_APART``), not by their
  totals. The channel mix's receptance ``w_r`` (its output axis
  ``embed_out`` is unsharded under the train rules): the port runs its
  forward and input gradient on the input's D/16 (D/32 on (2, 16, 16))
  for every output; XLA on (16, 16) on each device's 1/16 of the outputs
  too (1/256 of the product), on (2, 16, 16) as the port does. The weight
  gradients of ``w_r`` and of the time mix's ``w_o``: the port computes
  each device's own block, XLA every output of ``w_r``'s and every head
  of ``w_o``'s, 1/16 (1/32) of the product where the port's is 1/256
  (1/512). On (16, 16) the port's forward is 1.03e12 flops a device over
  the reference's and its backward 1.03e12 under, so the totals are
  equal by that cancellation alone; on (2, 16, 16) the forward is equal
  and the backward 1.03e12 under (0.855 of the reference's total; 0.765
  at full depth). XLA's choices here follow no rule of the parameters'
  specs (``w_o`` and the channel mix's ``w_v`` have the same spec, and
  XLA splits ``w_v``'s gradient), so the counter does not copy them;
* SmolLM on (2, 16, 16) (0.99932 at two layers and at 30): one product.
  Its 9 query heads do not divide "model", so the reshape into heads
  gathers them and the q gradient comes back whole on every device of
  "model". The q projection's input gradient is then split apart: the
  port gives the gradient its tiling again (36 of the 576 query columns a
  device) and contracts those, XLA contracts all 576 on every device
  (2 * rows * 18 * 576 flops a layer, where the port's is 2 * rows * 18 *
  36). On (16, 16) XLA keeps the tiling and contracts 36, as the port
  does, and it keeps it for the k and v projections on both meshes; the
  parameters' specs are the same on both, so the counter does not copy
  the (2, 16, 16) choice. The cell is held to the reference's flops less
  that one product (``TRACED_GAP``), inside a band no wider than it. The
  unembedding's backward is not apart: XLA's input gradient ``[rows/32,
  576]`` contracts each device's 3072 vocabulary columns, the same flops
  as the port's ``[rows, 18]``.

Collective bytes agree within a factor of 4 either way, as for the serve
cells (the partitioners reduce and move at different ops, and the
reference's CPU build holds bf16 products in float32). Static bytes are
equal. The flops and static bytes of the six two-layer cells are the
same on torch 2.11 (the card machine's) as on 2.13; the collective bytes
differ by up to 1.25% (``chip_smoke.py``'s cost phase prints both).
"""

import ast
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
TWO = {"num_layers": 2, "exits": (1, 2)}
V3 = {"num_layers": 2, "exits": (2,), "dense_prefix": 1}
# (arch, mesh, depth) -> (overrides, band of port flops / reference flops)
CELLS = {
    ("qwen3-8b", "single", "2"): (TWO, (1.0, 1.0)),
    ("deepseek-moe-16b", "single", "2"): (
        {"num_layers": 2, "exits": (2,)}, (1.0, 1.0)),
    ("deepseek-v3-671b", "single", "2"): (V3, (1.0, 1.0)),
    ("jamba-v0.1-52b", "single", "2"): (
        {"num_layers": 2, "exits": (2,), "attn_period": 2, "attn_offset": 1},
        (1.0, 1.0)),
    # held phase by phase instead (SPLIT_APART)
    ("rwkv6-1.6b", "single", "2"): (TWO, None),
    ("seamless-m4t-large-v2", "single", "2"): (TWO, (1.0, 1.0)),
    ("qwen3-8b", "multi", "2"): (TWO, (1.0, 1.0)),
    ("deepseek-v3-671b", "multi", "2"): (V3, (1.0, 1.0)),
    ("rwkv6-1.6b", "multi", "2"): (TWO, None),
    # one product short, by TRACED_GAP
    ("smollm-135m", "multi", "2"): (TWO, (0.99932, 1.0)),
    ("qwen3-8b", "single", "full"): ({}, (1.0, 1.0)),
}
DEPTH_CUT = [c for c in CELLS if c[2] != "full"]
COLLECTIVE_BAND = (0.25, 4.0)
# RWKV6's two [D, D] products that the port and XLA split apart (see the
# docstring), per mesh: a device's share of one such product over every
# row (2 * rows * D * D flops) in each layer's forward and backward,
# summed over the channel mix's receptance and the time mix's ``w_o``
D_RWKV, ROWS = 2048, 256 * 4096
SPLIT_APART = {
    # the port: receptance forward and input gradient on D/16 of its input
    # for every output; both weight gradients on a device's own block.
    # XLA: receptance forward and input gradient on a device's block; both
    # weight gradients for every output (w_o's for every head)
    "single": {"port": {"fw": 1 / 16, "bw": 1 / 16 + 2 / 256},
               "reference": {"fw": 1 / 256, "bw": 1 / 256 + 2 / 16}},
    # data 32-way: XLA too runs the receptance forward and input gradient
    # on D/32 of the input for every output
    "multi": {"port": {"fw": 1 / 32, "bw": 1 / 32 + 2 / 512},
              "reference": {"fw": 1 / 32, "bw": 1 / 32 + 2 / 32}},
}


# the one product XLA and the port split apart in SmolLM on (2, 16, 16)
# (see the docstring): the q projection's input gradient, which XLA
# contracts over all H * Dh = 576 query columns on each device of "model"
# and the port over the device's 36; rows * D/32 outputs, each layer
D_SMOLLM, Q_SMOLLM = 576, 576
TRACED_GAP = {
    ("smollm-135m", "multi", "2"):
        2 * ROWS * (D_SMOLLM // 32) * (Q_SMOLLM - Q_SMOLLM // 16)
        * TWO["num_layers"],
}


def _key(cell):
    return ":".join(cell)


def _phased(cell):
    return CELLS[cell][1] is None


# one mesh's cells; a cell held phase by phase also reports its dots'
# flops in the forward (``jvp``) and the backward (``transpose(jvp)``),
# read from its optimised HLO by ``tools/dryrun_diff.py::reference_dots``
_REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[4])
from dryrun_diff import reference_dots
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
multi = sys.argv[1] == "multi"
cells, phased = json.loads(sys.argv[2]), json.loads(sys.argv[3])
mesh = make_production_mesh(multi_pod=multi)
metrics = dryrun.hlo_metrics
kept = {}
dryrun.hlo_metrics = lambda text: kept.update(hlo=text) or metrics(text)
out = {}
for cell, overrides in cells.items():
    if "exits" in overrides:
        overrides["exits"] = tuple(overrides["exits"])
    rec = dryrun.lower_cell(cell.split(":")[0], "train_4k", mesh, multi,
                            overrides=overrides)
    out[cell] = {"flops": rec["hlo_metrics"]["flops"],
                 "collective_bytes": rec["collectives"]["bytes"]["total"],
                 "static": rec["bytes_per_device_static"]}
    if cell in phased:
        phases = {"fw": 0.0, "bw": 0.0}
        for key, flops in reference_dots(kept["hlo"]).items():
            phases["bw" if key.startswith("transpose(") else "fw"] += flops
        out[cell]["phases"] = phases
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's two subprocesses, started before the port counts
    its cells so that both run at once; (process, its output file)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out_dir = tmp_path_factory.mktemp("reference")
    runs = []
    for mesh in ("single", "multi"):
        cells = {_key(c): dict(ov, **({"exits": list(ov["exits"])}
                                      if "exits" in ov else {}))
                 for c, (ov, _) in CELLS.items() if c[1] == mesh}
        phased = [_key(c) for c in CELLS if c[1] == mesh and _phased(c)]
        out = out_dir / f"{mesh}.txt"
        with open(out, "w") as fh:
            runs.append((subprocess.Popen(
                [sys.executable, "-c", _REFERENCE, mesh, json.dumps(cells),
                 json.dumps(phased), str(ROOT / "tools")],
                env=env, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT,
                text=True), out))
    yield runs
    for run, _ in runs:
        if run.poll() is None:
            run.kill()
            run.wait()


@pytest.fixture(scope="module")
def port(reference_runs):
    recs = {}
    for multi in (False, True):
        release_mesh()
        mesh = make_production_mesh(multi_pod=multi)
        try:
            for cell, (overrides, _) in CELLS.items():
                if (cell[1] == "multi") != multi:
                    continue
                rec = dryrun.lower_cell(cell[0], "train_4k", mesh, multi,
                                        overrides=overrides or None,
                                        ledger=_phased(cell))
                recs[_key(cell)] = {
                    "flops": rec["hlo_metrics"]["flops"],
                    "collective_bytes": rec["collectives"]["bytes"]["total"],
                    "static": rec["bytes_per_device_static"]}
                if _phased(cell):
                    phases = {"fw": 0.0, "bw": 0.0}
                    for phase, *_, flops in rec["ledger"]["flops"]:
                        phases["fw" if phase == "fw" else "bw"] += flops
                    recs[_key(cell)]["phases"] = phases
        finally:
            release_mesh()
    return recs


@pytest.fixture(scope="module")
def reference(reference_runs, port):
    out = {}
    for run, path in reference_runs:
        run.wait(timeout=600)
        text = path.read_text()
        assert run.returncode == 0, text[-2000:]
        out.update(json.loads(next(line for line in reversed(
            text.splitlines()) if line.startswith("{"))))
    return out


@pytest.mark.parametrize("cell", list(CELLS), ids=[_key(c) for c in CELLS])
def test_flops_per_device_against_the_reference(reference, port, cell):
    ours, theirs = port[_key(cell)], reference[_key(cell)]
    if not _phased(cell):
        lo, hi = CELLS[cell][1]
        ratio = ours["flops"] / theirs["flops"]
        assert lo * (1 - 1e-9) <= ratio <= hi * (1 + 1e-9), ratio
        if cell in TRACED_GAP:
            # short by that one product and by nothing else
            assert (theirs["flops"] - ours["flops"]
                    == pytest.approx(TRACED_GAP[cell], rel=1e-9))
        return
    # every dot of the reference's and every product of the port's falls
    # in one phase or the other
    for side in (ours, theirs):
        assert sum(side["phases"].values()) == pytest.approx(
            side["flops"], rel=1e-12)
    # in each phase the two counts part by the products SPLIT_APART names
    # and by nothing else
    split = SPLIT_APART[cell[1]]
    layers = CELLS[cell][0]["num_layers"]
    for phase in ("fw", "bw"):
        apart = (2 * ROWS * D_RWKV * D_RWKV * layers
                 * (split["port"][phase] - split["reference"][phase]))
        assert (ours["phases"][phase] - theirs["phases"][phase]
                == pytest.approx(apart, rel=1e-9, abs=1.0)), phase


@pytest.mark.parametrize("cell", DEPTH_CUT, ids=[_key(c) for c in DEPTH_CUT])
def test_collective_bytes_against_the_reference(reference, port, cell):
    ratio = (port[_key(cell)]["collective_bytes"]
             / reference[_key(cell)]["collective_bytes"])
    assert COLLECTIVE_BAND[0] <= ratio <= COLLECTIVE_BAND[1], ratio


@pytest.mark.parametrize("cell", DEPTH_CUT, ids=[_key(c) for c in DEPTH_CUT])
def test_static_bytes_equal_the_references(reference, port, cell):
    assert port[_key(cell)]["static"] == reference[_key(cell)]["static"]


def _smoke_constants() -> dict:
    """The ``COST_*`` constants of ``chip_smoke.py``, read from its source
    (it imports nothing of the port at module level)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in ("COST_CELL", "COST_REFERENCE_FLOPS",
                                       "COST_TRAIN_CELLS", "COST_TRAIN_CPU")}


def test_chip_smoke_records_the_references_full_depth_count(reference):
    """``chip_smoke.py``'s cost phase holds the card machine's count of
    the full-depth Qwen3 cell to this recorded reference count."""
    recorded = _smoke_constants()
    assert recorded["COST_CELL"] == ("qwen3-8b", "train_4k")
    assert (recorded["COST_REFERENCE_FLOPS"]
            == reference["qwen3-8b:single:full"]["flops"])


SMOKE_TRAIN = [c for c in CELLS if c[1:] == ("single", "2")]


@pytest.mark.parametrize("cell", SMOKE_TRAIN,
                         ids=[c[0] for c in SMOKE_TRAIN])
def test_chip_smoke_records_the_ports_train_counts(port, cell):
    """``chip_smoke.py``'s cost phase counts the six two-layer (16, 16)
    cells on the card machine's torch and compares them with
    ``COST_TRAIN_CPU``: those are this file's cells and this torch's
    counts (flops, collective bytes, static bytes)."""
    recorded = _smoke_constants()
    assert recorded["COST_TRAIN_CELLS"][cell[0]] == CELLS[cell][0]
    ours = port[_key(cell)]
    assert recorded["COST_TRAIN_CPU"][cell[0]] == [
        ours["flops"], ours["collective_bytes"], ours["static"]]
    assert len(recorded["COST_TRAIN_CELLS"]) == len(SMOKE_TRAIN)
