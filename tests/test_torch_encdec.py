"""The port's encoder-decoder (SeamlessM4T backbone) against the JAX
reference on the CPU: the bidirectional encoder, cross-attention in both
forms (a prefill's queries, and one decode row through the
decode-attention wrapper), ``prepare_decode_cache``'s precomputed
cross-attention K/V, and the SMOKE model through every entry point.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro_torch.models.encdec import cross_attention

from torch_zoo import BATCH, SMAX, TOL, FamilyChecks, ZooPair

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"


class TestSeamless(FamilyChecks):
    ARCH = ARCH


def test_encoder_matches_reference():
    pair = ZooPair(ARCH)
    src = pair.batch_np["src_embeds"]
    want = jax.jit(pair.ref.encode)(pair.values, jnp.asarray(src))
    with torch.inference_mode():
        got = pair.port.encode(torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prepare_decode_cache_then_decode_matches_reference():
    """The cross-attention K/V of every decoder layer precomputed from the
    encoder output, then decode steps from an empty self-attention cache;
    every exit."""
    pair = ZooPair(ARCH)
    src = pair.batch_np["src_embeds"]
    tokens = pair.tokens(3)
    for e in range(pair.cfg.num_exits):
        ref_cache = pair.ref.prepare_decode_cache(
            pair.values, jnp.asarray(src), BATCH, SMAX, e)
        with torch.inference_mode():
            cache = pair.port.prepare_decode_cache(torch.from_numpy(src),
                                                   BATCH, SMAX, e)
        for got, want in zip(cache["segments"], ref_cache["segments"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    got["enc_kv"][key].numpy(),
                    np.asarray(want["enc_kv"][key]), **TOL)
        for i in range(3):
            tok = tokens[:, i:i + 1]
            want, ref_cache = pair.ref_step(tok, ref_cache, e)
            got, cache = pair.port_step(tok, cache, e)
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_one_row_cross_attention_equals_the_plain_form():
    """One query row goes through the decode-attention wrapper (all S_src
    positions valid); the same row as a 2-row prefill's first row, which
    takes the plain attention, gives the same output."""
    pair = ZooPair(ARCH)
    blk = pair.port.segments[0][0]
    acfg = pair.cfg.attn_config()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 2, 64)).astype(np.float32))
    enc_kv = {k: torch.from_numpy(rng.normal(size=(2, 16, 4, 16)).astype(
        np.float32)) for k in ("k", "v")}
    with torch.inference_mode():
        one = cross_attention(blk.xattn, x[:, :1], enc_kv, acfg)
        two = cross_attention(blk.xattn, x, enc_kv, acfg)
    np.testing.assert_allclose(one[:, 0].numpy(), two[:, 0].numpy(),
                               rtol=1e-5, atol=1e-5)
