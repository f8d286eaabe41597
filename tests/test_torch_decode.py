"""The port's KV-cache decode (``init_cache``, ``decode_step``, the cache
branch of ``attention``) against the JAX reference on the CPU.

The three dense SMOKE configs of the LM cell get the same numpy-seeded weights on both sides
(``lm_params_from_jax``); decode caches start equal (``init_cache`` on each
side, or one numpy cache through ``lm_cache_from_jax``), the same seeded
tokens go in, and every step's logits and caches must agree at float32
rtol/atol 2e-3, at every exit. This includes the reference's row-0-length
scatter with rows of different lengths and its clamp at a full cache.
"""

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

from test_torch_lm import LM_ARCHS, _numpy_values

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)
BATCH, SMAX, STEPS, PROMPT = 2, 8, 6, 5


class DecodePair:
    """The reference model and the port's with the same numpy-seeded
    weights, and the reference's jitted decode step and prefill (one
    compile per exit: every test uses one cache shape)."""

    def __init__(self, arch):
        self.cfg = get_config(arch, smoke=True)
        self.ref = ref_build_model(ref_get_config(arch, smoke=True))
        values_np = _numpy_values(self.ref, len(arch))
        self.values = jax.tree.map(jnp.asarray, values_np)
        self.port = build_model(self.cfg, device="cpu")
        self.port.load_state_dict(lm_params_from_jax(values_np, self.cfg))
        self.tokens = np.random.default_rng(len(arch) + 1).integers(
            0, self.cfg.vocab_size, (BATCH, PROMPT + STEPS))
        self._step = jax.jit(self.ref.decode_step, static_argnums=3)
        self._prefill = jax.jit(self.ref.prefill, static_argnums=2)

    def ref_step(self, token, cache, e):
        logits, cache = self._step(self.values, jnp.asarray(token), cache, e)
        return np.asarray(logits), cache

    def port_step(self, token, cache, e):
        with torch.inference_mode():
            return self.port.decode_step(torch.from_numpy(token), cache, e)

    def ref_prefill(self, tokens, e):
        return self._prefill(self.values, {"tokens": jnp.asarray(tokens)}, e)


@pytest.fixture(scope="module", params=LM_ARCHS)
def pair(request):
    return DecodePair(request.param)


def _assert_caches_equal(port_cache, ref_cache):
    assert len(port_cache["segments"]) == len(ref_cache["segments"])
    for got, want in zip(port_cache["segments"], ref_cache["segments"]):
        for key in ("k", "v"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), **TOL)
        assert got["len"].dtype == torch.int32
        np.testing.assert_array_equal(got["len"].numpy(),
                                      np.asarray(want["len"]))


def _numpy_cache(pair, e, lengths, seed):
    """A reference-shaped decode cache with seeded k/v and per-row
    ``lengths`` in every layer."""
    rng = np.random.default_rng(seed)
    segs = []
    for seg in pair.ref.init_cache(BATCH, SMAX, e)["segments"]:
        n = seg["k"].shape[0]
        segs.append({
            "k": rng.normal(size=seg["k"].shape).astype(np.float32),
            "v": rng.normal(size=seg["v"].shape).astype(np.float32),
            "len": np.tile(np.asarray(lengths, np.int32), (n, 1)),
        })
    return {"segments": segs}


@pytest.mark.parametrize("exit_idx", range(4))
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_init_cache_matches_reference(pair, exit_idx, dtype):
    got = pair.port.init_cache(BATCH, SMAX, exit_idx, dtype=dtype)
    want = pair.ref.init_cache(BATCH, SMAX, exit_idx,
                               dtype=None if dtype is None else jnp.bfloat16)
    assert len(got["segments"]) == len(want["segments"]) == (
        pair.cfg.exit_segment_index(exit_idx))
    for g, w in zip(got["segments"], want["segments"]):
        for key in ("k", "v", "len"):
            assert g[key].shape == w[key].shape
            assert str(g[key].dtype).split(".")[-1] == w[key].dtype.name
            assert g[key].device.type == "cpu" and not bool(g[key].any())


@pytest.mark.parametrize("exit_idx", range(4))
def test_decode_from_empty_cache_matches_reference(pair, exit_idx):
    port_cache = pair.port.init_cache(BATCH, SMAX, exit_idx)
    ref_cache = pair.ref.init_cache(BATCH, SMAX, exit_idx)
    for i in range(STEPS):
        tok = pair.tokens[:, i:i + 1]
        want, ref_cache = pair.ref_step(tok, ref_cache, exit_idx)
        got, port_cache = pair.port_step(tok, port_cache, exit_idx)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        _assert_caches_equal(port_cache, ref_cache)


@pytest.mark.parametrize("exit_idx", range(4))
def test_prefill_then_decode_matches_reference(pair, exit_idx):
    """Each side prefills the prompt, copies its caches into an
    ``init_cache`` buffer, then decodes the rest of the tokens."""
    prompt = pair.tokens[:, :PROMPT]
    with torch.inference_mode():
        _, port_pref = pair.port.prefill({"tokens": torch.from_numpy(prompt)},
                                         exit_idx)
    _, ref_pref = pair.ref_prefill(prompt, exit_idx)
    port_cache = pair.port.init_cache(BATCH, SMAX, exit_idx)
    ref_cache = pair.ref.init_cache(BATCH, SMAX, exit_idx)
    for buf, seg in zip(port_cache["segments"], port_pref["segments"]):
        buf["k"][:, :, :PROMPT] = seg["k"]
        buf["v"][:, :, :PROMPT] = seg["v"]
        buf["len"][:] = seg["len"]
    ref_cache = {"segments": [
        {"k": buf["k"].at[:, :, :PROMPT].set(seg["k"]),
         "v": buf["v"].at[:, :, :PROMPT].set(seg["v"]), "len": seg["len"]}
        for buf, seg in zip(ref_cache["segments"], ref_pref["segments"])]}
    _assert_caches_equal(port_cache, ref_cache)
    for i in range(PROMPT, PROMPT + 3):
        tok = pair.tokens[:, i:i + 1]
        want, ref_cache = pair.ref_step(tok, ref_cache, exit_idx)
        got, port_cache = pair.port_step(tok, port_cache, exit_idx)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_caches_equal(port_cache, ref_cache)


@pytest.mark.parametrize("exit_idx", range(4))
def test_decode_matches_forward_exit(pair, exit_idx):
    """The reference's own check (``tests/test_models.py:80``): step logits
    equal the full forward's at the same positions."""
    tokens = pair.tokens[:, :STEPS]
    with torch.inference_mode():
        full = pair.port.forward_exit({"tokens": torch.from_numpy(tokens)},
                                      exit_idx)
    cache = pair.port.init_cache(BATCH, SMAX, exit_idx)
    for i in range(STEPS):
        got, cache = pair.port_step(tokens[:, i:i + 1], cache, exit_idx)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   **TOL)


@pytest.mark.parametrize("exit_idx", range(4))
def test_rows_of_different_lengths_write_at_row_0s_length(pair, exit_idx):
    """With ``len = [5, 3]`` each row's RoPE uses its own length, but the
    new k/v land at row 0's slot (5) in both rows, as in the reference."""
    cache_np = _numpy_cache(pair, exit_idx, [5, 3], seed=exit_idx)
    port_cache = lm_cache_from_jax(cache_np, "cpu")
    ref_cache = jax.tree.map(jnp.asarray, cache_np)
    tok = pair.tokens[:, :1]
    want, ref_cache = pair.ref_step(tok, ref_cache, exit_idx)
    got, port_cache = pair.port_step(tok, port_cache, exit_idx)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_caches_equal(port_cache, ref_cache)
    k0 = cache_np["segments"][0]["k"]
    k1 = port_cache["segments"][0]["k"].numpy()
    assert not np.allclose(k1[:, 1, 5], k0[:, 1, 5])   # row 1 written at 5
    np.testing.assert_array_equal(k1[:, 1, 3], k0[:, 1, 3])  # not at 3
    np.testing.assert_array_equal(port_cache["segments"][0]["len"].numpy(),
                                  np.tile([6, 4], (k1.shape[0], 1)))


def test_full_cache_clamps_the_write(pair):
    """``len == Smax``: ``dynamic_update_slice`` clamps the start, so the
    step overwrites slot ``Smax - 1``; the port does the same."""
    e = pair.cfg.num_exits - 1
    cache_np = _numpy_cache(pair, e, [SMAX, SMAX], seed=11)
    port_cache = lm_cache_from_jax(cache_np, "cpu")
    ref_cache = jax.tree.map(jnp.asarray, cache_np)
    tok = pair.tokens[:, 1:2]
    want, ref_cache = pair.ref_step(tok, ref_cache, e)
    got, port_cache = pair.port_step(tok, port_cache, e)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_caches_equal(port_cache, ref_cache)
    k0 = cache_np["segments"][0]["k"]
    k1 = port_cache["segments"][0]["k"].numpy()
    np.testing.assert_array_equal(k1[:, :, :SMAX - 1], k0[:, :, :SMAX - 1])
    assert not np.allclose(k1[:, :, SMAX - 1], k0[:, :, SMAX - 1])


def test_bfloat16_cache_under_a_float32_model_matches_reference(pair):
    """``init_cache(dtype=bfloat16)``: the new k/v are rounded into the
    cache as the reference's ``astype`` rounds them; the attention runs in
    the cache's dtype (the reference promotes to float32), so the logits
    are held at the bfloat16 tolerance of ``tests/test_kernels.py``."""
    e = pair.cfg.num_exits - 1
    port_cache = pair.port.init_cache(BATCH, SMAX, e, dtype=torch.bfloat16)
    ref_cache = pair.ref.init_cache(BATCH, SMAX, e, dtype=jnp.bfloat16)
    for i in range(3):
        tok = pair.tokens[:, i:i + 1]
        want, ref_cache = pair.ref_step(tok, ref_cache, e)
        got, port_cache = pair.port_step(tok, port_cache, e)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)
    for got, want in zip(port_cache["segments"], ref_cache["segments"]):
        assert got["k"].dtype == torch.bfloat16
        np.testing.assert_allclose(got["k"].float().numpy(),
                                   np.asarray(want["k"], np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_decode_takes_embeds_like_the_reference(pair):
    """A ``[B, 1, D]`` token is taken as embeds (the modality frontend's
    path), skipping the embedding lookup."""
    e = pair.cfg.num_exits - 1
    embeds = np.random.default_rng(3).normal(
        size=(BATCH, 1, pair.cfg.d_model)).astype(np.float32)
    port_cache = pair.port.init_cache(BATCH, SMAX, e)
    ref_cache = pair.ref.init_cache(BATCH, SMAX, e)
    want, ref_cache = pair.ref_step(embeds, ref_cache, e)
    got, port_cache = pair.port_step(embeds, port_cache, e)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_caches_equal(port_cache, ref_cache)


def test_decode_takes_one_token(pair):
    cache = pair.port.init_cache(BATCH, SMAX, 0)
    with pytest.raises(ValueError, match="one token"):
        pair.port_step(pair.tokens[:, :3], cache, 0)
    with pytest.raises(ValueError, match="segments"):
        pair.port_step(pair.tokens[:, :1], cache, pair.cfg.num_exits - 1)


def test_lm_cache_from_jax_keeps_dtypes_and_values():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(2, 1, 4, 1, 16)).astype(np.float32)
    bf = np.asarray(jnp.asarray(k, jnp.bfloat16))
    cache = lm_cache_from_jax({"segments": [
        {"k": k, "v": bf, "len": np.array([[3], [3]], np.int32)}]}, "cpu")
    seg = cache["segments"][0]
    assert seg["k"].dtype == torch.float32 and seg["v"].dtype == torch.bfloat16
    np.testing.assert_array_equal(seg["k"].numpy(), k)
    np.testing.assert_array_equal(seg["v"].float().numpy(),
                                  bf.astype(np.float32))
    assert seg["len"].dtype == torch.int32
    assert seg["len"].tolist() == [[3], [3]]
    with pytest.raises(ValueError, match="k, v and len"):
        lm_cache_from_jax({"segments": [{"c_kv": k}]}, "cpu")
