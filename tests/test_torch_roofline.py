"""The port's roofline analysis against the JAX reference on the CPU:
``analyze_record``, ``advice``, ``fmt_s`` and ``markdown_table`` equal the
reference's once the port's H100 constants are patched to the reference's
v5e values (on the synthetic record of ``tests/test_artifacts.py`` and on
seeded random records); with the H100's own constants the terms are the
record's over 989 TFLOP/s, 3.35 TB/s and 450 GB/s. ``ProfileTable.
from_roofline`` equals the reference's on ``tests/test_profile.py::
test_from_roofline_builder``'s case and on seeded random terms; the served
quantum's roofline table (``roofline_profile``), counted on a one-device
mesh, has the flops that torch's own ``FlopCounterMode`` counts of a plain
``meta`` run and no collective, and every cell of it is positive and
monotone in B."""

import json

import numpy as np
import pytest
import torch

from repro.core.profile import ProfileTable as RefProfileTable
from repro.launch import roofline as RR

from repro_torch.core.profile import ProfileTable
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R

V5E = dict(PEAK_FLOPS_BF16=197e12, HBM_BW=819e9, LINK_BW=50e9)


def synthetic_record(**kw):
    rec = {
        "arch": "qwen3-8b", "shape": "train_4k", "kind": "train",
        "mesh": [16, 16], "mesh_axes": ["data", "model"],
        "num_devices": 256, "rules": "train-fsdp",
        "hlo_metrics": {"flops": 1e14, "bytes": 1e12},
        "collectives": {"bytes": {"total": 5e10}},
        "model_flops": 5.3e16,
        "bytes_per_device_static": 4e8,
        "serve_variant": "baseline",
    }
    rec.update(kw)
    return rec


def random_records(n=24, seed=0):
    rng = np.random.default_rng(seed)
    kinds = ("train", "prefill", "decode")
    out = []
    for i in range(n):
        flops = float(10 ** rng.uniform(9, 16))
        out.append(synthetic_record(
            kind=kinds[i % 3], arch=f"a{i}", shape=f"s{i}",
            num_devices=int(rng.choice([256, 512])),
            hlo_metrics={"flops": flops,
                         "bytes": float(10 ** rng.uniform(8, 13))},
            collectives={"bytes": {"total": float(10 ** rng.uniform(6, 12))}},
            model_flops=float(flops * rng.uniform(1, 600)),
            bytes_per_device_static=float(10 ** rng.uniform(7, 11))))
    return out


@pytest.fixture
def v5e(monkeypatch):
    for name, value in V5E.items():
        monkeypatch.setattr(R, name, value)


def test_h100_constants():
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.LINK_BW) == (989e12, 3.35e12,
                                                        450e9)
    r = R.analyze_record(synthetic_record())
    assert r["compute_s"] == 1e14 / 989e12
    assert r["memory_s"] == 1e12 / 3.35e12
    assert r["collective_s"] == 5e10 / 450e9
    assert r["dominant"] == "memory" and r["t_star"] == r["memory_s"]


def test_terms_and_dominance_equal_the_reference(v5e):
    rec = synthetic_record()
    assert R.analyze_record(rec) == RR.analyze_record(rec)
    r = R.analyze_record(rec)
    assert r["compute_s"] == pytest.approx(1e14 / 197e12)
    assert r["dominant"] == "memory"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_records_equal_the_reference(v5e, seed):
    recs = random_records(seed=seed)
    rows = [R.analyze_record(r) for r in recs]
    assert rows == [RR.analyze_record(r) for r in recs]
    assert R.markdown_table(rows) == RR.markdown_table(rows)


def test_roofline_fraction_definition(v5e):
    r = R.analyze_record(synthetic_record())
    ideal = (5.3e16 / 256) / 197e12
    assert r["roofline_frac"] == pytest.approx(ideal / r["t_star"])
    assert 0 < r["roofline_frac"] < 1


def test_skipped_and_error_records_pass_through():
    assert R.analyze_record({"skipped": "reason"}) is None
    assert R.analyze_record({"error": "trace"}) is None


@pytest.mark.parametrize("x", [2.5, 2.5e-3, 2.5e-6, 1.0, 1e-3, 0.0, 123.456])
def test_fmt_s(x):
    assert R.fmt_s(x) == RR.fmt_s(x)
    assert R.fmt_s(2.5) == "2.50s" and R.fmt_s(2.5e-6) == "2.5us"


def test_load_cells_and_cli(tmp_path, v5e):
    d = tmp_path / "art" / "single"
    d.mkdir(parents=True)
    for i, rec in enumerate(random_records(4)):
        (d / f"c{i}.json").write_text(json.dumps(rec))
    (d / "skip.json").write_text(json.dumps({"skipped": "x"}))
    rows = R.load_cells(str(tmp_path / "art"), "single")
    assert rows == RR.load_cells(str(tmp_path / "art"), "single")
    R.main(["--artifacts", str(tmp_path / "art"), "--out",
            str(tmp_path / "out")])
    assert (tmp_path / "out" / "roofline_single.md").read_text() == (
        RR.markdown_table(rows))


def test_from_roofline_builder():
    t = ProfileTable.from_roofline(
        ["m"], ["e0", "e1"], [1, 2],
        terms_fn=lambda m, e, b: (1e-3 * (e + 1) * b, 0.5e-3, 0.1e-3),
        safety=1.0, dispatch_overhead_s=0.0,
    )
    # compute-bound everywhere here: L = compute term
    np.testing.assert_allclose(t.latency[0, :, 0], [1e-3, 2e-3])
    np.testing.assert_allclose(t.latency[0, :, 1], [2e-3, 4e-3])
    assert t.meta["builder"] == "roofline"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_roofline_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    terms = rng.uniform(1e-5, 1e-2, size=(3, 4, 4, 3))
    acc = rng.uniform(0.5, 0.9, size=(3, 4))
    bs = (1, 2, 4, 8)
    kw = dict(model_names=["a", "b", "c"], exit_names=["e0", "e1", "e2", "e3"],
              batch_sizes=bs,
              terms_fn=lambda m, e, b: tuple(terms[m, e, bs.index(b)]),
              accuracy=acc, meta={"x": 1})
    got = ProfileTable.from_roofline(**kw)
    want = RefProfileTable.from_roofline(**kw)
    np.testing.assert_array_equal(got.latency, want.latency)
    np.testing.assert_array_equal(got.accuracy, want.accuracy)
    assert got.meta == want.meta
    assert (got.model_names, got.exit_names, got.batch_sizes) == (
        want.model_names, want.exit_names, want.batch_sizes)


def _plain_flops(cfg, exit_idx, batch_size, prompt_len):
    """torch's own ``FlopCounterMode`` over a plain ``meta`` run of the
    quantum: what one card computes, counted without a mesh."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import build_model
    from repro_torch.models.common import meta_generator
    from repro_torch.runtime.server import lm_payload

    model = build_model(cfg, device="meta").eval()
    batch = lm_payload(cfg, meta_generator(), prompt_len, batch_size)
    mode = FlopCounterMode(display=False)
    with torch.no_grad(), mode:
        model.exit_decision(batch, exit_idx)
    return mode.get_total_flops()


def test_quantum_roofline_table():
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, release_mesh

    cfgs = {a: get_config(a, smoke=True) for a in ("smollm-135m", "qwen3-8b")}
    release_mesh()
    try:
        mesh = make_host_mesh(device="cpu")
        table, counts = R.roofline_profile(cfgs, (1, 2, 8), 16, mesh)
    finally:
        release_mesh()
    assert table.latency.shape == (2, table.num_exits, 3)
    assert np.all(table.latency > 0)
    assert np.all(np.diff(table.latency, axis=2) >= 0)
    c = counts[(1, table.num_exits - 1, 8)]
    assert c["t_star"] == max(c["compute_s"], c["memory_s"],
                              c["collective_s"])
    # a one-device mesh counts what one card runs: the plain meta run's
    # flops, and no collective
    names = list(cfgs)
    for (m, e, b), c in counts.items():
        assert c["flops"] == _plain_flops(cfgs[names[m]], e, b, 16)
        assert c["collective_bytes"] == 0.0
