"""The RMSNorm q/k pair (``rmsnorm_pair``, one launch on the card) on the
CPU: two calls of the plain version bitwise, the JAX reference's
``rmsnorm_ref`` at the tolerances of ``tests/test_kernels.py:22-23``, and a
small Qwen3-style model with per-head q/k norm, whose prefill and decode go
through the pair once a layer and still match the reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rmsnorm.ref import rmsnorm_ref

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rmsnorm import rmsnorm_pair
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
from repro_torch.models import attention as attention_mod

from test_torch_decode import BATCH, PROMPT, SMAX, TOL, DecodePair

torch.set_num_threads(1)

KERNEL_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
              torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.normal(size=(tq, d)) * 3, rng.normal(size=d) * 0.2 + 1,
        rng.normal(size=(tk, d)) * 3, rng.normal(size=d) * 0.2 + 1)]


@pytest.mark.parametrize("tq,tk,d", [(32, 8, 128), (7, 3, 64), (1, 1, 100),
                                     (256, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_is_two_plain_calls_bitwise(tq, tk, d, dtype):
    xq, gq, xk, gk = (torch.from_numpy(a).to(dtype)
                      for a in _inputs(tq + tk, tq, tk, d))
    reset_launch_counts()
    oq, ok = rmsnorm_pair(xq, gq, xk, gk, eps=1e-6)
    assert launch_counts["rmsnorm"] == 0  # the CPU launches no kernel
    assert oq.dtype == ok.dtype == dtype
    assert torch.equal(oq, rmsnorm_plain(xq, gq, 1e-6))
    assert torch.equal(ok, rmsnorm_plain(xk, gk, 1e-6))


@pytest.mark.parametrize("tq,tk,d", [(32, 8, 128), (9, 3, 64), (5, 2, 576)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_matches_the_jax_reference(tq, tk, d, dtype):
    arrays = _inputs(d, tq, tk, d)
    xq, gq, xk, gk = (torch.from_numpy(a).to(dtype) for a in arrays)
    jq, jgq, jk, jgk = (jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays)
    oq, ok = rmsnorm_pair(xq, gq, xk, gk)
    for got, want in ((oq, rmsnorm_ref(jq, jgq, 1e-6)),
                      (ok, rmsnorm_ref(jk, jgk, 1e-6))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **KERNEL_TOL[dtype])


def test_pair_rejects_other_devices():
    # a meta tensor is shape-only evaluation (the dry-run, the cost
    # counter): the plain version, no launch; the card path's guard
    # still refuses every device but cuda
    from repro_torch.kernels import checks

    x = torch.zeros((2, 8), device="meta")
    reset_launch_counts()
    oq, ok = rmsnorm_pair(x, x[0], x, x[0])
    assert oq.device.type == ok.device.type == "meta" and oq.shape == x.shape
    assert sum(launch_counts.values()) == 0
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        checks.require_cuda(x, "rmsnorm")


@pytest.fixture(scope="module")
def qwen3():
    return DecodePair("qwen3-8b")


@pytest.fixture()
def pair_calls(monkeypatch):
    """Counts the attention layers' calls of the q/k pair."""
    calls = []
    real = attention_mod.rms_norm_pair

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(attention_mod, "rms_norm_pair", counted)
    return calls


@pytest.mark.parametrize("exit_idx", [0, 3])
def test_qk_norm_prefill_and_decode_match_the_reference(qwen3, pair_calls,
                                                         exit_idx):
    """The Qwen3 SMOKE config (per-head q/k norm): prefill, then decode
    from the prefilled cache, against the reference; one pair call a layer
    of each forward."""
    assert qwen3.cfg.qk_norm
    layers = qwen3.cfg.exits[exit_idx]
    prompt = qwen3.tokens[:, :PROMPT]
    with torch.inference_mode():
        got, port_pref = qwen3.port.prefill(
            {"tokens": torch.from_numpy(prompt)}, exit_idx)
    want, ref_pref = qwen3.ref_prefill(prompt, exit_idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(pair_calls) == layers
    port_cache = qwen3.port.init_cache(BATCH, SMAX, exit_idx)
    ref_cache = qwen3.ref.init_cache(BATCH, SMAX, exit_idx)
    for buf, seg in zip(port_cache["segments"], port_pref["segments"]):
        buf["k"][:, :, :PROMPT] = seg["k"]
        buf["v"][:, :, :PROMPT] = seg["v"]
        buf["len"][:] = seg["len"]
    ref_cache = {"segments": [
        {"k": buf["k"].at[:, :, :PROMPT].set(seg["k"]),
         "v": buf["v"].at[:, :, :PROMPT].set(seg["v"]), "len": seg["len"]}
        for buf, seg in zip(ref_cache["segments"], ref_pref["segments"])]}
    for i in range(PROMPT, PROMPT + 2):
        tok = qwen3.tokens[:, i:i + 1]
        want, ref_cache = qwen3.ref_step(tok, ref_cache, exit_idx)
        got, port_cache = qwen3.port_step(tok, port_cache, exit_idx)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert len(pair_calls) == 3 * layers
