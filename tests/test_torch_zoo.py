"""The port's model zoo against the JAX reference on the CPU: the ten LM
configs field by field, the two dense configs that came with the zoo
(StarCoder2-7B: G = 9 at full width, a GeLU MLP; LLaVA-NeXT: vision
embeds), ``build_model`` over the five families, and a mixed SMOKE
deployment (MoE, RWKV, Jamba, encoder-decoder) served live on the CPU on a
step clock.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models.transformer import LMConfig as RefLMConfig

from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.core import SchedulerConfig, make_scheduler, poisson_arrivals
from repro_torch.models import (
    DecoderLM,
    EncDecLM,
    JambaLM,
    RWKV6LM,
    build_model,
)
from repro_torch.runtime.server import (
    ServingEngine,
    measure_profile,
    serve_lms,
)

from torch_zoo import FamilyChecks

torch.set_num_threads(1)

FAMILY_CLASS = {"dense": DecoderLM, "moe": DecoderLM, "rwkv": RWKV6LM,
                "jamba": JambaLM, "encdec": EncDecLM}


def test_arch_ids_are_the_references_in_order():
    assert ARCH_IDS == list(REF_ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference_field_by_field(arch, smoke):
    ref, port = ref_get_config(arch, smoke), get_config(arch, smoke)
    for f in dataclasses.fields(RefLMConfig):
        if f.name == "dtype":
            assert str(port.dtype).split(".")[-1] == jnp.dtype(
                ref.dtype).name
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.segments() == ref.segments()
    assert all_configs(smoke)[arch] == port


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_gives_the_family_class(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    assert type(model) is FAMILY_CLASS[cfg.family]
    assert all(not p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="lstm"), device="cpu")


class TestStarCoder2(FamilyChecks):
    ARCH = "starcoder2-7b"


class TestLLaVA(FamilyChecks):
    ARCH = "llava-next-mistral-7b"


def test_serve_lms_payload_per_family():
    """Tokens, vision embeds, or source frames and tokens, sliced to B."""
    archs = ("llava-next-mistral-7b", "seamless-m4t-large-v2", "qwen3-8b")
    configs = {a: get_config(a, smoke=True) for a in archs}
    served = serve_lms(configs, device="cpu", prompt_len=6, max_batch=3)
    llava, seamless, qwen = (m.data_fn(2) for m in served)
    assert set(llava) == {"embeds"} and llava["embeds"].shape == (2, 16, 64)
    assert set(seamless) == {"src_embeds", "tokens"}
    assert seamless["src_embeds"].shape == (2, 16, 64)
    assert seamless["tokens"].shape == (2, 6)
    assert set(qwen) == {"tokens"} and qwen["tokens"].shape == (2, 6)
    for mod in served:
        idx, mx, lse = mod.forward_fn(mod.values, mod.data_fn(2), 0)
        assert idx.shape == (2,) and bool(torch.all(mx <= lse))


class StepClock:
    """A clock that moves 1 ms at every reading: a live run on it is the
    same on every machine."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def test_mixed_family_deployment_serves_every_request():
    """MoE, RWKV, Jamba and the encoder-decoder behind one scheduler, at
    the exits all four have (Jamba's SMOKE config has two)."""
    archs = ("deepseek-moe-16b", "rwkv6-1.6b", "jamba-v0.1-52b",
             "seamless-m4t-large-v2")
    served = serve_lms({a: get_config(a, smoke=True) for a in archs},
                       device="cpu", prompt_len=8, max_batch=2)
    assert [type(m.values) for m in served] == [DecoderLM, RWKV6LM, JambaLM,
                                                EncDecLM]
    n_exits = min(m.num_exits for m in served)
    for m in served:
        m.num_exits = n_exits
    table = measure_profile(served, batch_sizes=[1, 2], repeats=1, warmup=0)
    assert table.latency.shape == (4, n_exits, 2)
    sched = make_scheduler("edgeserving", table, SchedulerConfig(
        slo=1.0, max_batch=2, backend="cuda", device="cpu"))
    engine = ServingEngine(served, sched, clock=StepClock())
    arrivals = poisson_arrivals([20.0] * 4, 0.2, seed=3)
    completions, span = engine.run(arrivals, duration=0.2, drain=True,
                                   idle_sleep=0.0)
    m = engine.metrics(table, slo=1.0, span=span)
    assert len(arrivals) > 4
    assert len(completions) + engine.dropped + m.residual_queue == len(
        arrivals)
    assert sorted(c.req_id for c in completions) == sorted(
        r.req_id for r in arrivals)
    assert {c.model for c in completions} == set(range(len(archs)))
