"""The port's dense early-exit LMs against the JAX reference on the CPU.

The three SMOKE configs (SmolLM-135M, Phi-4-mini, Qwen3-8B at a few layers
and narrow widths) get the reference's weights (``jax.random.key(0)``)
converted by ``lm_params_from_jax`` and the same seeded numpy tokens; every
exit's ``forward_exit`` logits, ``prefill`` logits and caches, and the
served quantum's (token, max, logsumexp) must agree at float32 rtol/atol
2e-3. Then ``serve_lms`` serves the SMOKE deployment live on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.attention import _sdpa as ref_sdpa
from repro.models.common import apply_rope as ref_apply_rope
from repro.models.common import mask_padded_vocab as ref_mask_padded_vocab
from repro.models.moe import MLPConfig as RefMLPConfig
from repro.models.moe import mlp as ref_mlp
from repro.models.transformer import LMConfig as RefLMConfig

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import SchedulerConfig, make_scheduler, poisson_arrivals
from repro_torch.models import (
    DecoderLM,
    LMConfig,
    build_model,
    lm_params_from_jax,
)
from repro_torch.models.attention import _sdpa
from repro_torch.models.common import (
    apply_rope,
    make_param,
    mask_padded_vocab,
)
from repro_torch.models.moe import MLPConfig, mlp
from repro_torch.runtime.server import (
    ServedModel,
    ServingEngine,
    measure_profile,
    output_devices,
    serve_lms,
)

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)
# the dense LMs of the LM cell; the rest of the zoo has its own files
LM_ARCHS = ("smollm-135m", "phi4-mini-3.8b", "qwen3-8b")


def _numpy_values(ref, seed):
    """The reference's value tree filled from a numpy seed: matrices at the
    fan-in scale of ``make_param``, gains near 1 (not all ones, so that a
    gain applied to the wrong tensor shows)."""
    rng = np.random.default_rng(seed)
    shapes, _ = ref.abstract(jax.random.key(0))

    def fill(path, leaf):
        if "norm" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-2]
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class Pair:
    """A reference model with numpy-seeded values, the port's model with the
    converted values, seeded tokens, and the reference's (jitted) outputs
    per exit, computed once."""

    def __init__(self, ref_cfg, cfg, batch=2, seq=11):
        self.ref = ref_build_model(ref_cfg)
        values_np = _numpy_values(self.ref, len(cfg.arch_id))
        self.values = jax.tree.map(jnp.asarray, values_np)
        self.cfg = cfg
        self.port = build_model(cfg, device="cpu")
        self.port.load_state_dict(lm_params_from_jax(values_np, cfg))
        self.tokens = np.random.default_rng(len(cfg.arch_id)).integers(
            0, cfg.vocab_size, (batch, seq))
        self._ref_out = {}

    def batch(self):
        return {"tokens": torch.from_numpy(self.tokens)}

    def ref_out(self, kind, e):
        if (kind, e) not in self._ref_out:
            fn = jax.jit(getattr(self.ref, kind), static_argnums=2)
            self._ref_out[kind, e] = jax.tree.map(
                np.asarray, fn(self.values, {"tokens": jnp.asarray(
                    self.tokens)}, e))
        return self._ref_out[kind, e]


@pytest.fixture(scope="module", params=LM_ARCHS)
def pair(request):
    return Pair(ref_get_config(request.param, smoke=True),
                get_config(request.param, smoke=True))


@pytest.mark.parametrize("exit_idx", range(4))
def test_forward_exit_matches_reference(pair, exit_idx):
    with torch.inference_mode():
        got = pair.port.forward_exit(pair.batch(), exit_idx)
    want = pair.ref_out("forward_exit", exit_idx)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("exit_idx", range(4))
def test_prefill_logits_and_cache_match_reference(pair, exit_idx):
    with torch.inference_mode():
        logits, cache = pair.port.prefill(pair.batch(), exit_idx)
    want_logits, want_cache = pair.ref_out("prefill", exit_idx)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert len(cache["segments"]) == len(want_cache["segments"]) == (
        pair.cfg.exit_segment_index(exit_idx))
    for seg, want in zip(cache["segments"], want_cache["segments"]):
        for key in ("k", "v"):
            assert seg[key].shape == want[key].shape
            np.testing.assert_allclose(seg[key].numpy(), want[key], **TOL)
        assert seg["len"].dtype == torch.int32
        np.testing.assert_array_equal(seg["len"].numpy(), want["len"])


@pytest.mark.parametrize("exit_idx", range(4))
def test_exit_decision_is_top1_of_reference_prefill(pair, exit_idx):
    """The served quantum: (argmax, max, logsumexp) of the reference's
    last-position logits."""
    with torch.inference_mode():
        idx, mx, lse = pair.port.exit_decision(pair.batch(), exit_idx)
    logits = pair.ref_out("prefill", exit_idx)[0][:, 0]
    np.testing.assert_array_equal(idx.numpy(), logits.argmax(-1))
    np.testing.assert_allclose(mx.numpy(), logits.max(-1), **TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1)), **TOL)


def test_padded_untied_vocab_matches_reference():
    """A padded vocab masks its padded logits, and the exit head reads only
    the first V columns."""
    kw = dict(arch_id="pad", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=100,
              exits=(1, 2), vocab_pad_multiple=64)
    p = Pair(RefLMConfig(**kw), LMConfig(**kw), seq=5)
    with torch.inference_mode():
        got = p.port.forward_exit(p.batch(), 1)
        idx, mx, _ = p.port.exit_decision(p.batch(), 1)
    want = p.ref_out("forward_exit", 1)
    assert got.shape[-1] == 128
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(idx.numpy(), want[:, -1].argmax(-1))
    assert p.port.exit_head_weight().shape == (32, 100)


def test_config_fields_and_values_copy_across():
    ref_fields = [f.name for f in dataclasses.fields(RefLMConfig)]
    assert [f.name for f in dataclasses.fields(LMConfig)] == ref_fields
    for arch in ARCH_IDS:
        for smoke in (False, True):
            ref, port = ref_get_config(arch, smoke), get_config(arch, smoke)
            for name in ref_fields:
                if name == "dtype":
                    assert str(port.dtype).split(".")[-1] == jnp.dtype(
                        ref.dtype).name
                else:
                    assert getattr(port, name) == getattr(ref, name), name
            assert port.segments() == ref.segments()


def test_config_checks_raise():
    with pytest.raises(ValueError, match="deepest exit"):
        LMConfig(arch_id="x", family="dense", num_layers=3, d_model=8,
                 num_heads=2, num_kv_heads=1, d_ff=8, vocab_size=8,
                 exits=(1, 2))


def test_unported_paths_raise():
    """Every family of the reference is ported; a family it does not have
    raises, and DecoderLM takes only the dense and MoE families."""
    cfg = get_config("smollm-135m", smoke=True)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="lstm"), device="cpu")
    with pytest.raises(ValueError, match="dense and moe"):
        DecoderLM(dataclasses.replace(cfg, family="rwkv"), device="cpu")


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_is_interleaved_like_the_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :] + 5
    want = ref_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # rotate-half would pair x[i] with x[i + D/2]; check it is not that
    half = np.concatenate([x[..., 8:], x[..., :8]], -1)
    assert not np.allclose(got.numpy(), half, atol=1e-2)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    """The non-gated MLP uses the tanh GeLU, as jax.nn.gelu does."""
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=s).astype(np.float32) / 4 for k, s in
         (("w_up", (8, 16)), ("w_down", (16, 8)), ("w_gate", (8, 16)))}
    x = rng.normal(size=(3, 8)).astype(np.float32)
    want = ref_mlp({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), RefMLPConfig(8, 16, gated))
    got = mlp({k: torch.from_numpy(v) for k, v in p.items()},
              torch.from_numpy(x), MLPConfig(8, 16, gated))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sdpa_plain_path_matches_reference_with_offset_and_lengths():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    lens = np.array([9, 6], np.int32)
    want = ref_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                    q_offset=6, kv_len=jnp.asarray(lens))
    got = _sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                True, q_offset=6, kv_len=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mask_padded_vocab_matches_reference():
    x = np.random.default_rng(5).normal(size=(2, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        mask_padded_vocab(torch.from_numpy(x), 7).numpy(),
        np.asarray(ref_mask_padded_vocab(jnp.asarray(x), 7)))


@pytest.mark.parametrize("init,shape,bound", [
    ("normal", (64, 8), 2 / 8), ("embedding", (8, 64), 2 / 8)])
def test_make_param_scales_and_dtype(init, shape, bound):
    gen = torch.Generator().manual_seed(0)
    p = make_param(shape, gen, init=init, dtype=torch.bfloat16)
    assert p.dtype == torch.bfloat16 and not p.requires_grad
    assert float(p.float().abs().max()) <= bound * 1.01
    assert 0.5 * bound / 2 < float(p.float().std()) < bound / 2


def test_tied_head_copy_follows_loaded_weights():
    cfg = get_config("smollm-135m", smoke=True)
    model = DecoderLM(cfg, device="cpu")
    w = model.exit_head_weight()
    assert w.is_contiguous() and torch.equal(w, model.embed.T)
    sd = model.state_dict()
    sd["embed"] = sd["embed"] * 2
    model.load_state_dict(sd)
    assert torch.equal(model.exit_head_weight(), model.embed.T)


def test_same_seed_same_weights():
    cfg = get_config("qwen3-8b", smoke=True)
    a = DecoderLM(cfg, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    b = DecoderLM(cfg, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert "segments.3.0.attn.q_norm" in a.state_dict()


# ---------------------------------------------------------------------------
# live serving on the CPU
# ---------------------------------------------------------------------------


def test_tuple_output_reports_its_device_and_is_waited_for():
    """A forward that returns a (token, max, lse) tuple: run_quantum waits
    on every tensor and measure_profile names the device."""
    served = [ServedModel(
        "m0", None, lambda v, x, e: (x.sum(0), (x.max(), {"l": x})),
        lambda b: torch.ones((b, 2)), 2)]
    assert output_devices(served[0].forward_fn(None, torch.ones(1), 0)) == {
        torch.device("cpu")}
    table = measure_profile(served, batch_sizes=[1, 2], repeats=1, warmup=0)
    assert table.meta["platform"] == "cpu"
    assert output_devices((1, "x", None)) == set()


def test_serve_lms_smoke_deployment_serves_every_request():
    configs = {a: get_config(a, smoke=True) for a in LM_ARCHS}
    served = serve_lms(configs, device="cpu", prompt_len=16, max_batch=4)
    assert [m.name for m in served] == list(LM_ARCHS)
    idx, mx, lse = served[2].forward_fn(served[2].values,
                                        served[2].data_fn(3), 1)
    assert idx.shape == (3,) and idx.dtype == torch.int32
    assert bool(torch.all(mx <= lse))
    table = measure_profile(served, batch_sizes=[1, 2, 4], repeats=1,
                            warmup=1)
    assert table.latency.shape == (3, 4, 3)
    sched = make_scheduler("edgeserving", table, SchedulerConfig(
        slo=5.0, max_batch=4, backend="cuda", device="cpu"))
    engine = ServingEngine(served, sched)
    engine.warmup()
    arrivals = poisson_arrivals([30.0, 20.0, 10.0], 0.3, seed=1)
    completions, span = engine.run(arrivals, duration=0.3, drain=True)
    m = engine.metrics(table, slo=5.0, span=span)
    assert len(arrivals) > 5
    assert len(completions) + engine.dropped + m.residual_queue == len(
        arrivals)
    assert len(completions) == len(arrivals) and engine.dropped == 0
    assert sorted(c.req_id for c in completions) == sorted(
        r.req_id for r in arrivals)
