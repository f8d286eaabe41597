"""The port's dry-run counts held against the reference's ``lower_cell``
on the model zoo's serve cells: on the (16, 16) mesh a Mamba/MoE hybrid
(prefill, and the one-row ``long_500k`` decode), an RWKV-6, DeepSeek-V3's
MLA (prefill and decode) and a fine-grained MoE; on (2, 16, 16) the
encoder-decoder's ``decode_32k``; each cut to two layers with every width
FULL. The dense cells are in ``tests/test_torch_dryrun_reference.py``;
this file runs the same comparison, with the reference in a subprocess of
its own (512 host devices in ``XLA_FLAGS`` before JAX starts), both
meshes in turn.

The cuts (``CELLS``' overrides) keep every width and change the depth
only:

* ``jamba-v0.1-52b``: two layers need a superblock of two (the reference
  asserts ``num_layers % attn_period == 0``), so ``attn_period`` 2 and
  ``attn_offset`` 1: a Mamba sublayer with the MLP and an attention
  sublayer with the MoE (16 experts, top 2), one exit;
* ``deepseek-v3-671b``: ``dense_prefix`` 1, so that layer 2 is an MoE
  layer (256 experts, top 8) and its exit lies in the MoE region, as the
  reference asserts; both layers are MLA;
* ``deepseek-moe-16b`` (the MoE cell): its own dense first layer, then an
  MoE layer (64 experts, top 6, 2 shared);
* ``seamless-m4t-large-v2``: two decoder layers (exits 1 and 2); a decode
  step runs no encoder layer.

The bands of port flops over reference flops:

* Jamba, V3 prefill and decode, DeepSeek-MoE: equal. The Mamba and WKV
  time loops are billed as one trip times S
  (``kernels/checks.py::time_loop``), the reference's ``known_trip_count``
  weighting of its ``lax.scan``; MLA runs with its heads on "model", the
  WKV recurrence on each device's rows and heads, and the MoE's four
  einsums on each device's experts and tokens
  (``launch/graph_analysis.py::_mla_partition``, ``_wkv_partition``,
  ``_moe_partition``). The MLA decode is split on the cache's positions,
  as XLA splits it.
* Jamba ``long_500k``, Seamless ``decode_32k``: equal. Both run the
  decode-attention kernel, by its own rule
  (``launch/graph_analysis.py::_local_decode_attention``): the cache's
  positions split on "model", every head scored on the device's share.
  Jamba's one row leaves "data" idle, and XLA runs the value product there
  on the device's 2 of 32 query heads; ``DTensor`` had billed it on every
  head (1.354x the reference at two layers, 1.1333 at full depth).
  Seamless's flops were equal before; its collective bytes were not on
  torch 2.11, whose ``DTensor`` gathered the decode caches (5.81x the
  reference at two layers and at full depth, on the card machine's CPU;
  0.514x on 2.13). The rule moves q, the softmax's max and sum and the
  output only, and ``test_decode_attention_moves_no_cache`` holds that.
* RWKV6 prefill: 1.0-1.02. XLA computes the decay LoRA's second product
  (``tanh(xw @ decay_a) @ decay_b``) for the device's own channels only,
  as its consumer, the decay reshaped into heads, is sharded on "model".
  ``DTensor`` computes the whole ``[T, 2048]`` product on each device of
  the axis (``decay_b`` is replicated under the serve rules), which is
  1.61e10 flops a layer more: 1.51% of the cell.

Collective bytes a device agree within a factor of 4 either way, as for
the dense cells (the two partitioners reduce and gather at different
ops; the MoE layers' gathers dominate the port's prefill counts). Static
bytes a device are equal.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import checks
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import count
from repro_torch.launch.mesh import make_production_mesh, release_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TWO = {"num_layers": 2, "exits": (1, 2)}
# (arch, shape, mesh) -> (overrides, band of port flops / reference flops)
CELLS = {
    ("jamba-v0.1-52b", "prefill_32k", "single"): (
        {"num_layers": 2, "exits": (2,), "attn_period": 2, "attn_offset": 1},
        (1.0, 1.0)),
    ("rwkv6-1.6b", "prefill_32k", "single"): (TWO, (1.0, 1.02)),
    ("deepseek-v3-671b", "prefill_32k", "single"): (
        {"num_layers": 2, "exits": (2,), "dense_prefix": 1}, (1.0, 1.0)),
    ("deepseek-v3-671b", "decode_32k", "single"): (
        {"num_layers": 2, "exits": (2,), "dense_prefix": 1}, (1.0, 1.0)),
    ("deepseek-moe-16b", "prefill_32k", "single"): (
        {"num_layers": 2, "exits": (2,)}, (1.0, 1.0)),
    ("jamba-v0.1-52b", "long_500k", "single"): (
        {"num_layers": 2, "exits": (2,), "attn_period": 2, "attn_offset": 1},
        (1.0, 1.0)),
    ("seamless-m4t-large-v2", "decode_32k", "multi"): (TWO, (1.0, 1.0)),
}
COLLECTIVE_BAND = (0.25, 4.0)
IDS = ["-".join(c) for c in CELLS]

_REFERENCE = """
import json, sys
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
cells = json.loads(sys.argv[1])
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for cell, overrides in cells.items():
        arch, shape, name = cell.split(":")
        if (name == "multi") != multi:
            continue
        overrides["exits"] = tuple(overrides["exits"])
        rec = dryrun.lower_cell(arch, shape, mesh, multi,
                                overrides=overrides)
        out[cell] = {"flops": rec["hlo_metrics"]["flops"],
                     "collective_bytes": rec["collectives"]["bytes"]["total"],
                     "static": rec["bytes_per_device_static"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cells = {":".join(c): dict(ov, exits=list(ov["exits"]))
             for c, (ov, _) in CELLS.items()}
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(cells)],
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
            for (a, s, name), (overrides, _) in CELLS.items():
                if (name == "multi") != multi:
                    continue
                rec = dryrun.lower_cell(a, s, mesh, multi,
                                        overrides=overrides, ledger=True)
                recs[f"{a}:{s}:{name}"] = {
                    "flops": rec["hlo_metrics"]["flops"],
                    "collective_bytes": rec["collectives"]["bytes"]["total"],
                    "static": rec["bytes_per_device_static"],
                    "collectives": rec["ledger"]["collectives"]}
        finally:
            release_mesh()
    return recs


@pytest.mark.parametrize("cell", list(CELLS), ids=IDS)
def test_flops_per_device_against_the_reference(reference, port, cell):
    key = ":".join(cell)
    lo, hi = CELLS[cell][1]
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


def test_decode_attention_moves_no_cache(port):
    """Seamless's four decode attentions a two-layer step (self and cross
    a layer) move, by the decode attention's rule, q once (gathered over
    "model", which splits the cache's positions), the softmax's max and
    sum and the output once (all-reduced over it), and never a cache: 4
    rows a device, 16 heads of 64 in bfloat16, the max and sum in
    float32. Torch 2.11's ``DTensor`` gathered the caches here, 5.81x the
    reference's collective bytes (the card machine's CPU)."""
    moved = {}
    for phase, rule, kind, nbytes in port[
            "seamless-m4t-large-v2:decode_32k:multi"]["collectives"]:
        if rule == "decode_attention":
            moved[kind] = moved.get(kind, 0.0) + nbytes
    calls, q, stat = 4, 4 * 16 * 64 * 2, 4 * 16 * 4
    assert moved == {"all-gather": calls * q,
                     "all-reduce": calls * (q + 2 * stat)}


SMOKE_SERVE = [("jamba-v0.1-52b", "long_500k", "single"),
               ("seamless-m4t-large-v2", "decode_32k", "multi")]


@pytest.mark.parametrize("cell", SMOKE_SERVE, ids=[c[0] for c in SMOKE_SERVE])
def test_chip_smoke_records_the_decode_cells(reference, port, cell):
    """``chip_smoke.py``'s cost phase counts the decode attention's two
    serve cells on the card machine's torch: its ``COST_SERVE_*``
    constants are this file's overrides, this torch's counts and the
    reference's collective bytes."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    recorded = {node.targets[0].id: ast.literal_eval(node.value)
                for node in tree.body if isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("COST_SERVE_")}
    key = ":".join(cell)
    assert recorded["COST_SERVE_CELLS"][cell] == CELLS[cell][0]
    assert recorded["COST_SERVE_CPU"][cell] == [
        port[key]["flops"], port[key]["collective_bytes"],
        port[key]["static"]]
    assert (recorded["COST_SERVE_REFERENCE_COLLECTIVES"][cell]
            == reference[key]["collective_bytes"])
    assert set(recorded["COST_SERVE_CELLS"]) == set(SMOKE_SERVE)


def _every_trip(steps):
    """``checks.time_loop`` as if no counter were there: every trip."""
    import contextlib

    @contextlib.contextmanager
    def loop(n):
        yield n

    return loop(steps)


@pytest.mark.parametrize("family", ["mamba", "rwkv6"])
def test_one_trip_bills_what_every_trip_would(family, monkeypatch):
    """Under a cost count the time loop runs one trip billed S times;
    its flops equal those of the loop run trip by trip, and its outputs
    keep their shapes."""
    from repro_torch.models.mamba import _selective_scan
    from repro_torch.models.rwkv6 import _wkv_scan

    b, s, n = 2, 9, 4
    meta = torch.device("meta")
    if family == "mamba":
        di = 6
        args = (torch.empty(b, s, di, device=meta),
                torch.empty(b, s, di, device=meta),
                torch.empty(b, s, n, device=meta),
                torch.empty(b, s, n, device=meta),
                torch.empty(di, n, device=meta),
                torch.empty(di, device=meta), None)
        fn = _selective_scan
    else:
        h = 3
        args = tuple(torch.empty(b, s, h, n, device=meta) for _ in range(4)
                     ) + (torch.empty(h, n, device=meta), None)
        fn = _wkv_scan
    (y1, st1), one = count(fn, *args)
    monkeypatch.setattr(checks, "time_loop", _every_trip)
    (y2, st2), every = count(fn, *args)
    assert one.flops == every.flops > 0
    assert y1.shape == y2.shape and st1.shape == st2.shape
