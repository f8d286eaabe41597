"""The fleet tier and the ``serve_multi_model`` LMs on the card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fleet_cuda.py

Every test needs a card and skips without one: a fleet cell scored by the
``cuda`` stability kernel (every device's rounds through the one cached
backend) equals the ``numpy`` cell and launches once per scoring round;
the three LMs of ``examples/serve_multi_model.py`` agree with the CPU at
every exit at the float32 tolerance of ``tests/test_kernels.py:22-23``
(flash attention at head dims 16 and 32); and a live run with a tracer and
an online profiler launches what its quanta and traced rounds imply.
"""

import copy
import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch.core import (
    AdaptConfig,
    OnlineProfiler,
    ProfileTable,
    SchedulerConfig,
    SweepRunner,
    SweepSpec,
    Tracer,
    make_scheduler,
    poisson_arrivals,
)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.runtime.server import ServingEngine, measure_profile

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_multi_model", REPO / "examples_torch" / "serve_multi_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("dispatcher", ["stability-aware", "jsq"])
def test_cuda_fleet_cell_equals_numpy(card, dispatcher):
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    base = dict(policy="edgeserving", scenario="mmpp", rate=640.0, seed=7,
                horizon=2.0, fleet="heterogeneous", fleet_size=4,
                dispatcher=dispatcher)
    f64 = runner.run_cell(SweepSpec(**base))
    reset_launch_counts()
    f32 = runner.run_cell(SweepSpec(**base, backend="cuda"))
    launches = launch_counts["stability_score"]
    assert f32.metrics == f64.metrics
    # a greedy round with queued work always decides: one launch a quantum
    traced = runner.run_cell(SweepSpec(**base, trace=True))
    assert launches == len(traced.trace.decisions) > 0


@pytest.mark.cuda
def test_multi_model_lms_match_the_cpu_at_every_exit(card):
    example = _example()
    tokens = torch.randint(0, 512, (4, example.PROMPT_LEN),
                           generator=torch.Generator().manual_seed(0))
    for mod in example.make_deployment(card):
        model, cfg = mod.values, mod.values.cfg
        host = copy.deepcopy(model).to("cpu")
        reset_launch_counts()
        with torch.inference_mode():
            for e in range(cfg.num_exits):
                got = model.forward_exit({"tokens": tokens.to(card)}, e)
                want = host.forward_exit({"tokens": tokens}, e)
                torch.testing.assert_close(got.cpu(), want, **TOL)
                _, mx, lse = model.exit_decision(
                    {"tokens": tokens.to(card)}, e)
                _, w_mx, w_lse = host.exit_decision({"tokens": tokens}, e)
                torch.testing.assert_close(mx.cpu(), w_mx, **TOL)
                torch.testing.assert_close(lse.cpu(), w_lse, **TOL)
        layers = sum(cfg.exits[e] for e in range(cfg.num_exits))
        assert cfg.head_dim_ in (16, 32)
        assert launch_counts["flash_attention"] == 2 * layers
        assert launch_counts["exit_head"] == cfg.num_exits


@pytest.mark.cuda
def test_traced_profiled_live_run_launches_as_implied(card):
    example = _example()
    served = example.make_deployment(card)
    table = measure_profile(served, batch_sizes=[1, 2, 4, 8], repeats=3,
                            warmup=1)
    slo = float(table.latency.max() * 5)
    sched = make_scheduler("edgeserving", table, SchedulerConfig(
        slo=slo, max_batch=8, backend="cuda"))
    engine = ServingEngine(
        served, sched,
        profiler=OnlineProfiler(table, AdaptConfig(refresh_every=0.2)),
        tracer=Tracer())
    engine.warmup([1, 2, 4, 8])
    arrivals = poisson_arrivals([75.0, 50.0, 25.0], 1.0, seed=42)
    reset_launch_counts()
    completions, span = engine.run(arrivals, 1.0)
    trace = engine.trace(span=span, n_arrivals=len(arrivals))
    quanta = trace.decisions
    rescored = sum(1 for r in quanta if math.isfinite(r.margin))
    layers = [served[r.model].values.cfg.exits[r.exit_idx] for r in quanta]
    assert len(trace.spans) == len(arrivals) == len(completions)
    assert launch_counts["stability_score"] == len(quanta) + rescored
    assert launch_counts["flash_attention"] == sum(layers)
    assert launch_counts["rmsnorm"] == 2 * sum(layers)
    assert launch_counts["exit_head"] == len(quanta)
    refreshes = [e for e in trace.events if e.kind == "profiler-refresh"]
    assert engine.counters["profiler_refreshes"] == len(refreshes) > 0
