"""``examples_torch/serve_multi_model.py`` against the reference example's
deployment on the CPU.

The three dense float32 LMs (lm0-lm2: 2/2/4 layers, d 64/128/128, 4 heads,
2 kv heads, d_ff = 4d, vocab 512, an exit at every layer) get the
reference example's own weights (``jax.random.key(i)``) converted by
``lm_params_from_jax``; every exit's ``forward_exit`` logits must agree with
the reference's at the float32 kernel tolerance of ``tests/test_kernels.py``
(rtol = atol = 2e-3), on the deployment's zero-token prompts and on seeded
random tokens, and the served quantum (``exit_decision``) must be the
argmax, max and logsumexp of the reference's last-position logits. Then the
example itself serves a short trace on the CPU and writes a trace that
``tools/tracestats.py`` reads.
"""

import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import build_model as ref_build_model
from repro.models import split_params
from repro.models.transformer import LMConfig as RefLMConfig

from repro_torch.models import build_model, lm_params_from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_kernels.py:22-23, float32

torch.set_num_threads(1)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _load(REPO / "examples_torch" / "serve_multi_model.py",
                 "port_serve_multi_model")


@pytest.fixture(scope="module")
def reference():
    return _load(REPO / "examples" / "serve_multi_model.py",
                 "ref_serve_multi_model")


def test_configs_are_the_reference_deployment(example):
    cfgs = example.deployment_configs()
    assert [(c.arch_id, c.num_layers, c.d_model, c.head_dim_) for c in cfgs] == [
        ("lm0", 2, 64, 16), ("lm1", 2, 128, 32), ("lm2", 4, 128, 32)]
    for i, (layers, d) in enumerate([(2, 64), (2, 128), (4, 128)]):
        want = RefLMConfig(
            arch_id=f"lm{i}", family="dense", num_layers=layers, d_model=d,
            num_heads=4, num_kv_heads=2, d_ff=4 * d, vocab_size=512,
            exits=tuple(range(1, layers + 1)))
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(cfgs[i], f.name) == getattr(want, f.name)
        assert cfgs[i].dtype == torch.float32


@pytest.fixture(scope="module")
def pairs(example):
    """(port model with the reference's weights, the reference's
    ServedModel) per LM; the reference's values come from its example's own
    init (``jax.random.key(i)``)."""
    out = []
    for i, cfg in enumerate(example.deployment_configs()):
        ref_cfg = RefLMConfig(
            arch_id=cfg.arch_id, family="dense", num_layers=cfg.num_layers,
            d_model=cfg.d_model, num_heads=4, num_kv_heads=2,
            d_ff=cfg.d_ff, vocab_size=512, exits=cfg.exits)
        ref_model = ref_build_model(ref_cfg)
        values, _ = split_params(ref_model.init(jax.random.key(i)))
        port = build_model(cfg, device="cpu").eval()
        port.load_state_dict(lm_params_from_jax(
            jax.tree.map(np.asarray, values), cfg))
        out.append((port, ref_model, values))
    return out


def _tokens(kind, b=3):
    if kind == "zeros":
        return np.zeros((b, 16), np.int64)
    return np.random.default_rng(b).integers(0, 512, (b, 16))


@pytest.mark.parametrize("kind", ["zeros", "random"])
@pytest.mark.parametrize("model", range(3))
def test_forward_exit_matches_the_reference_at_every_exit(pairs, model, kind):
    port, ref_model, values = pairs[model]
    tokens = _tokens(kind)
    fn = jax.jit(ref_model.forward_exit, static_argnums=2)
    for e in range(port.cfg.num_exits):
        with torch.inference_mode():
            got = port.forward_exit({"tokens": torch.from_numpy(tokens)}, e)
        want = np.asarray(fn(values, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)}, e))
        assert got.shape == want.shape == (3, 16, 512)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"lm{model} exit {e}")
        with torch.inference_mode():
            idx, mx, lse = port.exit_decision(
                {"tokens": torch.from_numpy(tokens)}, e)
        last = want[:, -1]
        np.testing.assert_array_equal(idx.numpy(), last.argmax(-1))
        np.testing.assert_allclose(mx.numpy(), last.max(-1), **TOL)
        np.testing.assert_allclose(
            lse.numpy(), np.asarray(jax.nn.logsumexp(last, axis=-1)), **TOL)


def test_deployment_serves_the_reference_shapes(example, reference):
    ref = reference.make_deployment()
    got = example.make_deployment(device="cpu")
    assert [m.name for m in got] == [m.name for m in ref]
    assert [m.num_exits for m in got] == [m.num_exits for m in ref] == [2] * 3
    for m in got:
        x = m.data_fn(4)
        assert x.shape == (4, 16) and not bool(x.any())
        token, mx, lse = m.forward_fn(m.values, x, m.num_exits - 1)
        assert token.shape == mx.shape == lse.shape == (4,)
        assert bool(torch.all(mx <= lse))
    # model i's weights come from a generator seeded i
    again = example.make_deployment(device="cpu")
    for a, b in zip(got, again):
        for pa, pb in zip(a.values.parameters(), b.values.parameters()):
            assert torch.equal(pa, pb)


def test_the_example_serves_and_writes_a_trace(tmp_path):
    path = tmp_path / "live.ndjson"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "serve_multi_model.py"),
         "--device", "cpu", "--duration", "0.3", "--rate", "60",
         "--trace", str(path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "== online serving phase:" in out.stdout
    assert "completed=" in out.stdout and path.exists()
    stats = subprocess.run(
        [sys.executable, str(REPO / "tools" / "tracestats.py"), str(path)],
        capture_output=True, text=True, timeout=120, env=env)
    assert stats.returncode == 0, stats.stderr
    assert "engine=live" in stats.stdout
