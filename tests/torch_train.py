"""Helpers shared by the port's training tests against the JAX reference
on the CPU: one model pair per config (the reference with numpy-seeded
values, the port with the same values through ``lm_params_from_jax`` or
``resnet_params_from_jax``), seeded batches, the reference's loss and
gradient carried across by parameter name, and the gradient tolerance.

Gradient tolerance: a leaf holds when max|got - want| <= 2e-3 * (1 +
max|want|), the float32 tolerance of ``tests/test_kernels.py:22`` scaled by
the leaf's own largest gradient: an elementwise 2e-3 fails on leaves whose
gradients reach the tens while their float32 summation order differs.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models import EarlyExitResNet as RefResNet
from repro.models import build_model as ref_build_model
from repro.models import split_params
from repro.models.transformer import LMConfig as RefLMConfig

from repro_torch.models import (
    EarlyExitResNet,
    LMConfig,
    build_model,
    lm_params_from_jax,
    resnet_params_from_jax,
)

import test_models as ref_model_tests
from test_torch_lm import _numpy_values

GRAD_TOL = 2e-3
LOSS_RTOL = 1e-5


def port_cfg(ref_cfg) -> LMConfig:
    """The port's LMConfig of a reference LMConfig (float32)."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(RefLMConfig)}
    fields["dtype"] = torch.float32
    return LMConfig(**fields)


def tiny_cfg(family, **kw):
    """The reference's ``tiny_cfg`` (``tests/test_models.py:19``)."""
    return ref_model_tests.tiny_cfg(family, **kw)


def lm_batch_np(cfg, seed, batch=2, seq=6):
    """Seeded tokens and labels (+ source frames for the encoder-decoder,
    embeds in place of tokens for a vision frontend)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = rng.normal(size=(
            batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        b = {"embeds": rng.normal(size=(batch, seq, cfg.d_model)).astype(
            np.float32), "labels": b["labels"]}
    return b


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class LMPair:
    """The reference model of ``ref_cfg`` with numpy-seeded values, the
    port's model with the same values (on the CPU), and a seeded batch."""

    def __init__(self, ref_cfg, seed=0, batch=2, seq=6):
        self.ref_cfg = ref_cfg
        self.cfg = port_cfg(ref_cfg)
        self.ref = ref_build_model(ref_cfg)
        self.values_np = _numpy_values(self.ref, seed)
        self.values = to_jax(self.values_np)
        self.port = build_model(self.cfg, device="cpu")
        self.port.load_state_dict(lm_params_from_jax(self.values_np,
                                                     self.cfg))
        self.batch_np = lm_batch_np(self.cfg, seed + 1, batch, seq)

    def to_names(self, tree_np):
        """A reference tree shaped like the values, by port name."""
        return lm_params_from_jax(tree_np, self.cfg)


class ResNetPair:
    def __init__(self, ref_cfg, cfg, seed=0, batch=4):
        self.ref = RefResNet(ref_cfg)
        values, _ = split_params(self.ref.init(jax.random.key(seed)))
        self.values_np = jax.tree.map(np.asarray, values)
        self.values = to_jax(self.values_np)
        self.cfg = cfg
        self.port = EarlyExitResNet(cfg, device="cpu")
        self.port.load_state_dict(resnet_params_from_jax(self.values_np, cfg))
        rng = np.random.default_rng(seed + 1)
        self.batch_np = {
            "images": rng.normal(size=(batch, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, cfg.num_classes, batch).astype(
                np.int32)}

    def to_names(self, tree_np):
        return resnet_params_from_jax(tree_np, self.cfg)


def ref_loss_and_grads(pair):
    """(loss, metrics, gradients by port name) of the reference."""
    fn = jax.jit(jax.value_and_grad(
        lambda v, b: pair.ref.train_loss(v, b), has_aux=True))
    (loss, metrics), grads = fn(pair.values, to_jax(pair.batch_np))
    grads_np = jax.tree.map(np.asarray, grads)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in pair.to_names(grads_np).items()})


def port_loss_and_grads(model, batch):
    """(loss, metrics, gradients by name) of the port's ``train_loss`` on
    the model's own parameters, gradients turned on for the test."""
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = model.train_loss(batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss, metrics, grads


def assert_grad_close(name, got, want, tol=GRAD_TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    bound = tol * (1.0 + float(np.max(np.abs(want))) if want.size else 1.0)
    assert err <= bound, f"{name}: max abs err {err} beyond {bound}"
