"""The port's LM families against the JAX reference on the CPU: one harness
for every family (dense, moe with or without MLA, jamba, rwkv, encdec).

``ZooPair`` gives the reference model numpy-seeded values
(``test_torch_lm._numpy_values``) and the port's model the same values
through ``lm_params_from_jax``; the same seeded numpy batch goes to both.
``FamilyChecks`` holds the checks every family runs: ``forward_exit`` at
every exit, ``prefill`` logits and caches, ``decode_step`` from one seeded
cache (through ``lm_cache_from_jax``), a prefill followed by decode steps,
and the served quantum ``exit_decision`` against the reference's
last-position logits, at float32 rtol/atol 2e-3. A test file subclasses it
as ``Test...`` with ``ARCH`` set.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.models import (
    build_model,
    lm_cache_from_jax,
    lm_params_from_jax,
)

from test_torch_lm import _numpy_values

TOL = dict(rtol=2e-3, atol=2e-3)
BATCH, SEQ, SMAX, STEPS = 2, 11, 16, 3


def numpy_batch(cfg, seed, batch=BATCH, seq=SEQ):
    """A seeded batch of ``cfg``'s family: tokens, vision embeds, or the
    encoder-decoder's source frames and target tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq))
    if cfg.family == "encdec":
        return {"src_embeds": rng.normal(size=(
            batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32),
            "tokens": tokens}
    if cfg.frontend == "vision":
        return {"embeds": rng.normal(size=(batch, seq, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": tokens}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def assert_trees_close(got, want, tol=TOL):
    """A port cache (nested dicts and lists of tensors) against the
    reference's (the same structure, numpy or jax leaves)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for key in want:
            assert_trees_close(got[key], want[key], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees_close(g, w, tol)
    else:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got.numpy(), want)
            assert got.dtype == torch.int32
        else:
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32), **tol)


def seeded_cache(cache, seed, lengths):
    """A numpy copy of the reference cache ``cache`` with seeded values:
    float leaves ~ N(0, 1) (Mamba ``h`` and RWKV ``wkv`` scaled by 0.1),
    ``len`` leaves ``lengths`` per row."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        if "len" in key:
            return np.tile(np.asarray(lengths, np.int32), (leaf.shape[0], 1))
        scale = 0.1 if ("'h'" in key or "wkv" in key) else 1.0
        return (scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, cache)


class ZooPair:
    """The reference and port models of one SMOKE arch (``overrides``
    replace config fields on both sides), with the same weights (which
    ``edit_values`` may change in place first), a seeded batch and the
    reference's jitted outputs, each computed once."""

    def __init__(self, arch, seq=SEQ, edit_values=None, **overrides):
        ref_cfg = ref_get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        if overrides:
            ref_cfg = dataclasses.replace(ref_cfg, **overrides)
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.ref = ref_build_model(ref_cfg)
        seed = len(arch)
        values_np = _numpy_values(self.ref, seed)
        if edit_values is not None:
            edit_values(values_np)
        self.values = to_jax(values_np)
        self.port = build_model(cfg, device="cpu")
        self.port.load_state_dict(lm_params_from_jax(values_np, cfg))
        self.seq = seq
        self.batch_np = numpy_batch(cfg, seed, seq=seq)
        self._out = {}
        self._step = jax.jit(self.ref.decode_step, static_argnums=3)

    def batch(self):
        return to_torch(self.batch_np)

    def ref_out(self, kind, e):
        if (kind, e) not in self._out:
            fn = jax.jit(getattr(self.ref, kind), static_argnums=2)
            self._out[kind, e] = jax.tree.map(
                np.asarray, fn(self.values, to_jax(self.batch_np), e))
        return self._out[kind, e]

    def ref_init_cache(self, e):
        kw = {"src_len": self.cfg.frontend_seq} \
            if self.cfg.family == "encdec" else {}
        return self.ref.init_cache(BATCH, SMAX, e, **kw)

    def ref_step(self, token, cache, e):
        logits, cache = self._step(self.values, jnp.asarray(token), cache, e)
        return np.asarray(logits), cache

    def port_step(self, token, cache, e):
        with torch.inference_mode():
            return self.port.decode_step(torch.from_numpy(token), cache, e)

    def tokens(self, n, seed=99):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (BATCH, n))


def prefill_into_buffers(buf, pref, prompt):
    """A decode cache from ``init_cache``'s buffers ``buf`` holding a
    prefill's caches ``pref`` (numpy or torch leaves; the same nested
    structure): attention k/v (and MLA's latent) at positions < prompt, the
    rest (lengths, states, cross-attention K/V) whole."""
    if isinstance(buf, dict):
        return {key: prefill_into_buffers(buf[key], pref[key], prompt)
                for key in buf}
    if isinstance(buf, list):
        return [prefill_into_buffers(b, p, prompt)
                for b, p in zip(buf, pref)]
    buf = np.array(buf)
    pref = np.asarray(pref)
    if buf.shape == pref.shape:
        return pref.astype(buf.dtype)
    buf[:, :, :prompt] = pref
    return buf


class FamilyChecks:
    """Checks every LM family runs against the reference; a subclass sets
    ``ARCH`` (and ``OVERRIDES`` to change config fields)."""

    ARCH = None
    OVERRIDES = {}
    SEQ = SEQ

    @pytest.fixture(scope="class")
    def pair(self):
        return ZooPair(self.ARCH, seq=self.SEQ, **self.OVERRIDES)

    def test_forward_exit_matches_reference(self, pair):
        for e in range(pair.cfg.num_exits):
            with torch.inference_mode():
                got = pair.port.forward_exit(pair.batch(), e)
            want = pair.ref_out("forward_exit", e)
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_prefill_logits_and_cache_match_reference(self, pair):
        for e in range(pair.cfg.num_exits):
            with torch.inference_mode():
                logits, cache = pair.port.prefill(pair.batch(), e)
            want_logits, want_cache = pair.ref_out("prefill", e)
            np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
            assert_trees_close(cache, want_cache)

    def test_exit_decision_is_top1_of_reference_prefill(self, pair):
        for e in range(pair.cfg.num_exits):
            with torch.inference_mode():
                idx, mx, lse = pair.port.exit_decision(pair.batch(), e)
            logits = pair.ref_out("prefill", e)[0][:, 0]
            np.testing.assert_array_equal(idx.numpy(), logits.argmax(-1))
            np.testing.assert_allclose(mx.numpy(), logits.max(-1), **TOL)
            np.testing.assert_allclose(
                lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1)),
                **TOL)

    def test_init_cache_matches_reference(self, pair):
        for e in range(pair.cfg.num_exits):
            got = pair.port.init_cache(BATCH, SMAX, e)
            want = jax.tree.map(np.asarray, pair.ref_init_cache(e))
            assert_trees_close(got, want, dict(rtol=0, atol=0))

    def test_decode_from_one_cache_matches_reference(self, pair):
        """Both sides step from one seeded numpy cache (ragged lengths),
        every exit."""
        tokens = pair.tokens(STEPS)
        for e in range(pair.cfg.num_exits):
            cache_np = seeded_cache(pair.ref_init_cache(e), 10 + e, [5, 3])
            port_cache = lm_cache_from_jax(cache_np, "cpu")
            ref_cache = to_jax(cache_np)
            for i in range(STEPS):
                tok = tokens[:, i:i + 1]
                want, ref_cache = pair.ref_step(tok, ref_cache, e)
                got, port_cache = pair.port_step(tok, port_cache, e)
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), want, **TOL)
            assert_trees_close(port_cache, ref_cache)

    def test_prefill_then_decode_matches_reference(self, pair):
        """Each side prefills the batch, moves its caches into
        ``init_cache`` buffers and decodes teacher-forced tokens, at the
        final exit."""
        e = pair.cfg.num_exits - 1
        prompt = pair.seq
        _, ref_pref = pair.ref_out("prefill", e)
        with torch.inference_mode():
            _, port_pref = pair.port.prefill(pair.batch(), e)
        port_np = jax.tree.map(lambda t: t.numpy(), port_pref)
        bufs = jax.tree.map(np.asarray, pair.ref_init_cache(e))
        ref_cache = to_jax(prefill_into_buffers(bufs, ref_pref,
                                                prompt))
        port_cache = lm_cache_from_jax(
            prefill_into_buffers(bufs, port_np, prompt), "cpu")
        for i, tok in enumerate(pair.tokens(STEPS, seed=5).T):
            tok = tok[:, None]
            want, ref_cache = pair.ref_step(tok, ref_cache, e)
            got, port_cache = pair.port_step(tok, port_cache, e)
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert_trees_close(port_cache, ref_cache)
