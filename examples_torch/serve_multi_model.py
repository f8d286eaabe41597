"""End-to-end live serving example on the PyTorch port: three early-exit LMs
of increasing cost share one card under time-division; the offline phase
measures the real profile table; the online phase serves a Poisson trace
with the EdgeServing scheduler and reports SLO compliance. The deployment
and the printed lines are those of ``examples/serve_multi_model.py``.

A quantum is the served decision at the prompt's last position: the trunk
through the exit, then the fused exit-head kernel, giving the top-1 token,
its logit and the logsumexp (``DecoderLM.exit_decision``; the argmax, max
and logsumexp of ``forward_exit``'s last-position logits).

  PYTHONPATH=src python examples_torch/serve_multi_model.py \\
      [--duration 3.0] [--rate 150] [--device cpu] [--trace out.ndjson]

``--trace PATH`` attaches a record-only ``Tracer`` to the engine and writes
the live run's timeline as NDJSON, which ``python3 tools/tracestats.py
PATH`` summarises. Without ``--device cpu`` it runs on the CUDA card.
"""

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import (
    EdgeServingScheduler,
    SchedulerConfig,
    Tracer,
    export_ndjson,
    poisson_arrivals,
)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import LMConfig
from repro_torch.runtime.server import ServedModel, ServingEngine, measure_profile

# (layers, d_model) of lm0-lm2: cost ordering mimics R50 < R101 < R152
LAYOUT = ((2, 64), (2, 128), (4, 128))
PROMPT_LEN = 16
BATCH_SIZES = (1, 2, 4, 8)


def deployment_configs() -> List[LMConfig]:
    """The three dense float32 LMs: 4 heads, 2 kv heads, d_ff = 4d, vocab
    512 and an exit at every layer."""
    return [
        LMConfig(
            arch_id=f"lm{i}", family="dense", num_layers=layers,
            d_model=d, num_heads=4, num_kv_heads=2, d_ff=4 * d,
            vocab_size=512, exits=tuple(range(1, layers + 1)),
        )
        for i, (layers, d) in enumerate(LAYOUT)
    ]


def make_deployment(device: Optional[str] = None,
                    max_batch: int = BATCH_SIZES[-1]) -> List[ServedModel]:
    """One :class:`ServedModel` per config, model ``i``'s weights from a
    ``torch.Generator`` seeded ``i`` on the device; the payload of a batch
    of B is B zero-token prompts of ``PROMPT_LEN``, sliced from one buffer
    of ``max_batch`` rows made once on the device. Exit counts are trimmed
    to the smallest, since the profile table needs one E for every model."""
    dev = resolve_device(device)
    prompts = torch.zeros((max_batch, PROMPT_LEN), dtype=torch.long,
                          device=dev)
    models = []
    for i, cfg in enumerate(deployment_configs()):
        gen = torch.Generator(device=dev).manual_seed(i)
        model = build_model(cfg, generator=gen, device=dev).eval()
        models.append(ServedModel(
            name=f"lm{i}-{cfg.num_layers}L-d{cfg.d_model}", values=model,
            forward_fn=lambda mod, x, e: mod.exit_decision({"tokens": x}, e),
            data_fn=lambda b, _p=prompts: _p[:b],
            num_exits=cfg.num_exits))
    e_min = min(m.num_exits for m in models)
    for m in models:
        m.num_exits = e_min
    return models


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--rate", type=float, default=150.0,
                    help="total request rate (req/s), 3:2:1 split")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the live run's telemetry as NDJSON")
    args = ap.parse_args()

    models = make_deployment(args.device)
    print("== offline profiling phase (real wall-clock, this machine) ==")
    table = measure_profile(models, batch_sizes=list(BATCH_SIZES), repeats=5,
                            warmup=2)
    for mi, name in enumerate(table.model_names):
        lat = ", ".join(
            f"{e}={table.latency[mi, ei, 0]*1e3:.2f}ms"
            for ei, e in enumerate(table.exit_names))
        print(f"  {name}: B=1 {lat}")

    # SLO: 5x the slowest profiled quantum
    slo = float(table.latency.max() * 5)
    print(f"SLO tau = {slo*1e3:.1f} ms")

    cfg = SchedulerConfig(slo=slo, max_batch=BATCH_SIZES[-1])
    tracer = Tracer() if args.trace else None
    engine = ServingEngine(models, EdgeServingScheduler(table, cfg),
                           tracer=tracer)
    print("== warmup: every (m, e, B) once ==")
    engine.warmup(list(BATCH_SIZES))

    unit = args.rate / 6.0
    arrivals = poisson_arrivals([3 * unit, 2 * unit, unit], args.duration,
                                seed=42)
    print(f"== online serving phase: {len(arrivals)} requests over "
          f"{args.duration:.1f}s ==")
    completions, span = engine.run(arrivals, args.duration, drain=True)
    m = engine.metrics(table, slo=slo, span=span)
    print(f"completed={m.num_completed} dropped={m.dropped} "
          f"P95={m.p95_latency*1e3:.2f}ms violations={m.violation_ratio*100:.2f}% "
          f"mean_exit_depth={m.mean_exit_depth:.2f} util={m.utilization:.2f}")
    exits = np.array([c.exit_idx for c in completions])
    for e in range(int(exits.max()) + 1):
        print(f"  exit {e}: {np.mean(exits == e)*100:.1f}% of requests")
    if args.trace:
        trace = engine.trace(horizon=args.duration, span=span,
                             warmup_used=m.warmup_used,
                             n_arrivals=len(arrivals))
        export_ndjson(trace, args.trace)
        print(f"trace: {len(trace.decisions)} decisions, {len(trace.spans)} "
              f"spans, {len(trace.events)} events -> {args.trace}")


if __name__ == "__main__":
    main()
