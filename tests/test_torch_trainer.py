"""The port's train step against the reference's on the CPU: three AdamW
steps of the float32 SMOKE SmolLM through both ``make_train_step``s from
the same values (losses per step at rtol 1e-5, every value after the third
step at 2e-3), ``grad_accum`` against the full batch (the reference's
``test_grad_accum_matches_full_batch``), float32 masters under a bfloat16
config, the memorization corpus learnt, the ResNet's loss lowered, and the
sharding helpers that wait for the port's mesh."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as ref_get_config
from repro.optim import AdamW as RefAdamW
from repro.runtime.trainer import make_train_step as ref_make_train_step

from repro_torch.configs import SMOKE, get_config
from repro_torch.data import cifar100_like, synthetic_memorization_corpus
from repro_torch.distributed.sharding import train_rules, tree_leaves
from repro_torch.models import EarlyExitResNet, build_model
from repro_torch.optim import Adafactor, AdamW
from repro_torch.runtime.trainer import (
    TrainConfig,
    abstract_opt_state,
    make_train_step,
    master_values,
    opt_state_shardings,
    pick_optimizer_for,
)

from torch_train import LMPair, to_jax, to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trajectories():
    """Three AdamW steps through each package's train step."""
    pair = LMPair(ref_get_config("smollm-135m", smoke=True), seed=7,
                  batch=4, seq=16)
    ref_opt, opt = RefAdamW(lr=3e-3), AdamW(lr=3e-3)
    rv, rs = pair.values, ref_opt.init(pair.values)
    ref_step = jax.jit(ref_make_train_step(pair.ref, ref_opt))
    pv = master_values(pair.port)
    ps = opt.init(pv)
    step = make_train_step(pair.port, opt)
    ref_m, port_m = [], []
    for i in range(3):
        rv, rs, m = ref_step(rv, rs, to_jax(pair.batch_np), i)
        ref_m.append({k: float(v) for k, v in m.items()})
        pv, ps, m = step(pv, ps, to_torch(pair.batch_np), i)
        port_m.append({k: float(v) for k, v in m.items()})
    return pair, (rv, ref_m), (pv, port_m)


def test_losses_per_step_match_reference(trajectories):
    _, (_, ref_m), (_, port_m) = trajectories
    for want, got in zip(ref_m, port_m):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)


def test_values_after_three_steps_match_reference(trajectories):
    pair, (rv, _), (pv, _) = trajectories
    want = pair.to_names(jax.tree.map(np.asarray, rv))
    assert set(pv) == set(want)
    for name, w in want.items():
        assert pv[name].dtype == torch.float32
        np.testing.assert_allclose(pv[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


def test_grad_accum_matches_full_batch():
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    values = master_values(model)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    v1, _, m1 = make_train_step(model, opt)(values, opt.init(values), batch,
                                            0)
    v2, _, m2 = make_train_step(model, opt, grad_accum=4)(
        values, opt.init(values), batch, 0)
    assert set(m2) == {"loss", "grad_norm"}
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-4)
    # Adam's rsqrt amplifies float32 summation-order noise; 1e-3 of the
    # lr-scale update is well below one optimizer step of drift.
    diff = max(float((v1[k] - v2[k]).abs().max()) for k in v1)
    assert diff < 1e-3


def test_bf16_config_keeps_float32_masters():
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              dtype=torch.bfloat16)
    model = build_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    values = master_values(model)
    assert all(v.dtype == torch.float32 for v in values.values())
    opt = AdamW(lr=1e-3)
    state = opt.init(values)
    batch = synthetic_memorization_corpus(cfg.vocab_size, n=2, seq=8,
                                          device="cpu")
    new, state, metrics = make_train_step(model, opt)(values, state, batch, 0)
    assert all(v.dtype == torch.float32 for v in new.values())
    assert metrics["loss"].dtype == torch.float32
    assert any(not torch.equal(new[k], values[k]) for k in values)
    # the serving parameters are neither read for the step nor changed
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad
        assert torch.equal(p, before[n]), n


def test_memorization_loss_falls():
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    values = master_values(model)
    opt = AdamW(lr=5e-3, weight_decay=0.0)
    state = opt.init(values)
    step = make_train_step(model, opt)
    batch = synthetic_memorization_corpus(cfg.vocab_size, n=4, seq=16,
                                          device="cpu")
    losses = []
    for i in range(30):
        values, state, metrics = step(values, state, batch, i)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_resnet_step_lowers_its_loss():
    model = EarlyExitResNet(SMOKE["resnet50"], device="cpu")
    values = master_values(model)
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    state = opt.init(values)
    imgs, labels = cifar100_like(8, seed=1, device="cpu")
    batch = {"images": imgs, "labels": labels}
    step = make_train_step(model, opt)
    losses = []
    for i in range(6):
        values, state, metrics = step(values, state, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert {"acc_exit0", "nll_exit3", "grad_norm"} <= set(metrics)


def test_pick_optimizer_and_the_mesh_helpers():
    assert isinstance(pick_optimizer_for(get_config("deepseek-v3-671b")),
                      Adafactor)
    assert isinstance(pick_optimizer_for(get_config("jamba-v0.1-52b")),
                      Adafactor)
    assert pick_optimizer_for(get_config("smollm-135m"), lr=0.1) == AdamW(
        lr=0.1)
    assert TrainConfig() == TrainConfig("adamw", 3e-4, 1.0, 1, False)
    # the mesh helpers work: shape-only state and its shardings
    values = {"w": torch.zeros(256, 512), "b": torch.zeros(32)}
    axes = {"w": ("embed", "mlp"), "b": ("embed",)}
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    for opt in (AdamW(), Adafactor()):
        state = abstract_opt_state(opt, values)
        assert [(p, tuple(t.shape), t.dtype) for p, t in tree_leaves(
            state)] == [(p, tuple(t.shape), t.dtype)
                        for p, t in tree_leaves(opt.init(values))]
        assert all(t.device.type == "meta" for _, t in tree_leaves(state))
        shardings = opt_state_shardings(opt, values, axes, train_rules(),
                                        mesh)
        if isinstance(opt, AdamW):
            assert state["m"]["w"].device.type == "meta"
            assert shardings["m"]["w"].spec == ("data", "model")
            assert shardings["v"]["b"].spec == ("data",)
        else:
            assert tuple(state["v"]["w"]["vr"].shape) == (256,)
            assert shardings["v"]["w"]["vr"].spec == ("data",)
            assert shardings["v"]["w"]["vc"].spec == ("model",)
