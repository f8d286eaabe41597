"""The port's ``Checkpointer`` on the CPU: the reference's
``TestCheckpointer`` cases (``tests/test_runtime.py``), a bfloat16 leaf,
byte-identical saves, leaf files byte-identical to the reference's in both
directions, and a bitwise restart of training (the reference's
``examples/elastic_failover.py`` without its mesh: 30 steps with saves,
preempted at 25, restored into a fresh model and optimizer, 5 more steps).
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.runtime.checkpoint import Checkpointer as RefCheckpointer

from repro_torch.configs import get_config
from repro_torch.data import synthetic_memorization_corpus
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime import checkpoint as C
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.runtime.fault_tolerance import PreemptionGuard
from repro_torch.runtime.trainer import make_train_step, master_values

torch.set_num_threads(1)


def _tree(k=0):
    return {"w": torch.arange(12.0).reshape(3, 4) + k,
            "opt": {"m": torch.ones(5) * k}}


class TestCheckpointer:
    def test_roundtrip(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=False)
        ck.save(7, _tree(1), extra={"loss": 2.5})
        step, tree, extra = ck.restore(template=_tree())
        assert step == 7 and extra["loss"] == 2.5
        assert torch.equal(tree["w"], _tree(1)["w"])
        assert torch.equal(tree["opt"]["m"], _tree(1)["opt"]["m"])

    def test_async_save_and_wait(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=True)
        ck.save(1, _tree(1))
        ck.save(2, _tree(2))
        ck.wait()
        assert ck.committed_steps() == [1, 2]

    def test_atomic_commit_markers(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=False)
        ck.save(3, _tree())
        # a torn write: a directory without its marker is invisible
        os.makedirs(tmp_path / "step_000000009")
        assert ck.latest_step() == 3
        with pytest.raises(FileNotFoundError):
            ck.restore(step=9, template=_tree())

    def test_keep_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
        for s in range(5):
            ck.save(s, _tree(s))
        assert ck.committed_steps() == [3, 4]

    def test_restore_latest_by_default(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=False)
        for s in (1, 5, 3):
            ck.save(s, _tree(s))
        step, tree, _ = ck.restore(template=_tree())
        assert step == 5
        assert torch.equal(tree["opt"]["m"], torch.full((5,), 5.0))


def test_save_snapshots_before_it_returns(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    tree = _tree(1)
    ck.save(1, tree)
    tree["w"].add_(100.0)  # the caller may change its tensors at once
    ck.wait()
    _, got, _ = ck.restore()
    assert torch.equal(got["w"], _tree(1)["w"])


def test_wait_raises_the_workers_error(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), async_save=True)

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(C.np, "save", fail)
    ck.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.committed_steps() == []


def test_bfloat16_leaf_round_trip(tmp_path):
    tree = {"h": torch.randn(4, 6, generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16), "f": torch.zeros(2)}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, tree)
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == ["float32", "bfloat16"]
    assert manifest["treedef"] == [["f"], ["h"]]
    _, got, _ = ck.restore(template=tree)
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"], tree["h"])
    _, untemplated, _ = ck.restore()
    assert torch.equal(untemplated["h"], tree["h"])


def test_restore_rejects_another_structure(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree())
    with pytest.raises(ValueError, match="key paths"):
        ck.restore(template={"w": torch.zeros(3, 4)})


def test_two_saves_of_one_tree_are_byte_identical(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for root in (a, b):
        Checkpointer(str(root), async_save=False).save(4, _tree(3))
    cmp = filecmp.dircmp(a / "step_000000004", b / "step_000000004")
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    for name in os.listdir(a / "step_000000004"):
        assert filecmp.cmp(a / "step_000000004" / name,
                           b / "step_000000004" / name, shallow=False)


def _mixed_np():
    rng = np.random.default_rng(0)
    return {"values": {"b": rng.normal(size=(3,)).astype(np.float32),
                       "a": rng.normal(size=(2, 5)).astype(np.float32)},
            "count": np.arange(6, dtype=np.int32).reshape(2, 3),
            "opt": {"m": {"z": np.ones((4,), np.float32)}}}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_leaves_are_byte_identical_to_the_references(tmp_path):
    tree = _mixed_np()
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        2, _map(tree, jnp.asarray))
    Checkpointer(str(tmp_path / "port"), async_save=False).save(
        2, _map(tree, torch.from_numpy))
    ref_dir = tmp_path / "ref" / "step_000000002"
    port_dir = tmp_path / "port" / "step_000000002"
    leaves = sorted(n for n in os.listdir(ref_dir) if n.endswith(".npy"))
    assert leaves == sorted(n for n in os.listdir(port_dir)
                            if n.endswith(".npy"))
    assert len(leaves) == 4
    for name in leaves:
        assert filecmp.cmp(ref_dir / name, port_dir / name, shallow=False)
    with open(ref_dir / "manifest.json") as f:
        ref_manifest = json.load(f)
    with open(port_dir / "manifest.json") as f:
        manifest = json.load(f)
    assert set(manifest) == set(ref_manifest)
    for key in ("step", "num_leaves", "shapes", "dtypes", "extra"):
        assert manifest[key] == ref_manifest[key], key


def test_each_package_restores_the_others_checkpoint(tmp_path):
    tree = _mixed_np()
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        3, _map(tree, jnp.asarray))
    _, got, _ = Checkpointer(str(tmp_path / "ref")).restore(
        template=_map(tree, torch.from_numpy))
    for (k, g), (_, w) in zip(C.flatten(got), C.flatten(tree)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(k))
        assert g.numpy().dtype == w.dtype
    Checkpointer(str(tmp_path / "port"), async_save=False).save(
        3, _map(tree, torch.from_numpy))
    _, back, _ = RefCheckpointer(str(tmp_path / "port")).restore(
        template=_map(tree, jnp.asarray))
    for (k, g), (_, w) in zip(C.flatten(back), C.flatten(tree)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(k))


def test_restart_is_bitwise(tmp_path):
    """30 steps with a save every 10, preempted at 25, restored into a
    fresh model and optimizer: 5 more steps equal the uninterrupted run's
    bit for bit on the CPU."""
    cfg = get_config("smollm-135m", smoke=True)

    def fresh():
        model = build_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        opt = AdamW(lr=3e-3, weight_decay=0.0)
        values = master_values(model)
        return make_train_step(model, opt), values, opt.init(values)

    step_fn, values, opt_state = fresh()
    batch = synthetic_memorization_corpus(cfg.vocab_size, device="cpu")
    ck = Checkpointer(str(tmp_path), keep=2)
    guard = PreemptionGuard()
    for step in range(30):
        values, opt_state, _ = step_fn(values, opt_state, batch, step)
        if (step + 1) % 10 == 0:
            ck.save(step + 1, {"values": values, "opt": opt_state})
        if step == 24:
            guard.request_stop()  # the preemption notice arrives
        if guard.should_stop():
            ck.save(step + 1, {"values": values, "opt": opt_state})
            break
    ck.wait()
    assert ck.committed_steps() == [20, 25]

    step_fn2, values2, opt2 = fresh()
    step0, state, _ = ck.restore(template={"values": values2, "opt": opt2})
    assert step0 == 25
    v_a, o_a = values, opt_state
    v_b, o_b = state["values"], state["opt"]
    for step in range(step0, step0 + 5):
        v_a, o_a, m_a = step_fn(v_a, o_a, batch, step)
        v_b, o_b, m_b = step_fn2(v_b, o_b, batch, step)
        assert float(m_a["loss"]) == float(m_b["loss"])
    for name in v_a:
        assert torch.equal(v_a[name], v_b[name]), name
    for key in ("m", "v"):
        for name in o_a[key]:
            assert torch.equal(o_a[key][name], o_b[key][name]), name
