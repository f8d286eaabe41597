"""The port's multi-head latent attention (DeepSeek-V3) against the JAX
reference on the CPU: the SMOKE model through every entry point in both
decode forms (the expanded latent and the absorbed matrices), the two
forms against each other, and the MLA layer alone.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.attention import MLAConfig as RefMLAConfig
from repro.models.attention import mla_attention as ref_mla_attention

from repro_torch.configs import get_config
from repro_torch.models import build_model, lm_cache_from_jax
from repro_torch.models.attention import (
    MLAConfig,
    init_mla,
    mla_attention,
    mla_attention_absorbed,
)

from torch_zoo import BATCH, SMAX, TOL, FamilyChecks, seeded_cache

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"


class TestDeepSeekV3(FamilyChecks):
    ARCH = ARCH


class TestDeepSeekV3Absorbed(FamilyChecks):
    """``mla_absorbed_decode``: the decode steps take the absorbed form on
    both sides."""
    ARCH = ARCH
    OVERRIDES = dict(mla_absorbed_decode=True)


def test_absorbed_decode_equals_expanded_decode():
    cfg = get_config(ARCH, smoke=True)
    expanded = build_model(cfg, generator=torch.Generator().manual_seed(4),
                           device="cpu")
    absorbed = build_model(dataclasses.replace(cfg, mla_absorbed_decode=True),
                           device="cpu")
    absorbed.load_state_dict(expanded.state_dict())
    template = ref_build_model(ref_get_config(ARCH, smoke=True)).init_cache(
        BATCH, SMAX, 3)
    cache_np = seeded_cache(template, 8, [6, 2])
    caches = [lm_cache_from_jax(cache_np, "cpu") for _ in range(2)]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, 4))
    with torch.inference_mode():
        for i in range(4):
            tok = torch.from_numpy(tokens[:, i:i + 1])
            a, caches[0] = expanded.decode_step(tok, caches[0], 3)
            b, caches[1] = absorbed.decode_step(tok, caches[1], 3)
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                       atol=1e-4)
    for seg_a, seg_b in zip(caches[0]["segments"], caches[1]["segments"]):
        for key in ("c_kv", "k_pe", "len"):
            torch.testing.assert_close(seg_b[key], seg_a[key], rtol=1e-5,
                                       atol=1e-5)


def test_mla_layer_prefill_and_row0_scatter_match_reference():
    kw = dict(d_model=32, num_heads=4, q_lora_rank=16, kv_lora_rank=8,
              qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)
    params = init_mla(torch.Generator().manual_seed(0), MLAConfig(**kw))
    p_np = {k: v.detach().numpy() for k, v in params.items()}
    p_jax = {k: jnp.asarray(v) for k, v in p_np.items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want, want_cache = ref_mla_attention(p_jax, jnp.asarray(x),
                                         RefMLAConfig(**kw),
                                         position=jnp.zeros((), jnp.int32))
    got, got_cache = mla_attention(params, torch.from_numpy(x),
                                   MLAConfig(**kw), position=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("c_kv", "k_pe", "len"):
        np.testing.assert_allclose(got_cache[key].numpy(),
                                   np.asarray(want_cache[key]), **TOL)
    # one step against a cache whose rows differ in length: the new latent
    # lands at row 0's length in both rows
    cache = {"c_kv": rng.normal(size=(2, 7, 8)).astype(np.float32),
             "k_pe": rng.normal(size=(2, 7, 4)).astype(np.float32),
             "len": np.array([4, 2], np.int32)}
    x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
    want, want_cache = ref_mla_attention(
        p_jax, jnp.asarray(x1), RefMLAConfig(**kw),
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_cache = mla_attention(params, torch.from_numpy(x1),
                                   MLAConfig(**kw), cache=t_cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_cache["c_kv"].numpy(),
                               np.asarray(want_cache["c_kv"]), **TOL)
    assert got_cache["c_kv"] is t_cache["c_kv"]  # written in place
    np.testing.assert_array_equal(got_cache["c_kv"][1, 2].numpy(),
                                  cache["c_kv"][1, 2])
    got_abs, _ = mla_attention_absorbed(
        params, torch.from_numpy(x1), MLAConfig(**kw),
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    np.testing.assert_allclose(got_abs.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-5)
