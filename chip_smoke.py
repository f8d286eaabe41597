#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It drives the port's main path, the paper's deployment, end to end:

1. device and build: the card's name and power limit, the CUDA kernel built
   from ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a``, TF32 off;
2. the stability-score kernel against its plain PyTorch version on the card
   (greedy, lattice and many-queue shapes; scalar and per-task tau; two
   clips), its argmin against the float64 numpy backend, and its time;
3. the full-width early-exit ResNet-50/101/152 on the card against the same
   modules on the CPU at every exit;
4. live serving: ``measure_profile`` over the 120-cell table, then the
   EdgeServing scheduler with the ``cuda`` scoring backend serving the
   paper's fig4 knee (lambda_152 = 140 req/s at 3:2:1, 3 s, drained), with a
   float64 numpy shadow scheduler on the same snapshots;
5. the kernel summary line, then ``{"ok": true, ...}`` as the last line.

Each phase prints JSON lines. Any failed check raises, so the script exits
non-zero before the last line. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's published peaks (H100 SXM data sheet): HBM rate and float32
# (non-tensor-core) rate, for the kernel's least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
OPS_PER_ELEMENT = 8   # add, div, sub, min, exp, min, mul, add per (n, task)

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
MODEL_TOL = 1e-3
TIE_RTOL = 1e-6
SLO = 0.050
LAMBDA_152 = 140.0
HORIZON_S = 3.0


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, per_graph: int = 20) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph and replayed ``iters`` times, so the host's launch cost is
    not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, iters) / per_graph


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device_and_build():
    import torch

    from repro_torch.kernels import build

    card = smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    path = build.build(["stability_score"])["stability_score"]
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.BUILD_LOG.get(
        "stability_score", {}).get("ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("build", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, library=path.name,
         build_seconds=seconds, ptxas=ptxas)
    return card


# ---------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------


def _kernel_case(rng, m, q, n, het, clip):
    """Host float64 inputs as the scheduler holds them."""
    w = np.sort(rng.uniform(0, 0.2, (m, q)))[:, ::-1].copy()
    mask = (rng.uniform(size=(m, q)) > 0.2).astype(np.float64)
    n_c = m if n is None else n
    lat = rng.uniform(1e-3, 3e-2, n_c)
    bat = rng.integers(1, min(q, 10) + 1, n_c)
    queue = np.arange(m) if n is None else rng.integers(0, m, n)
    tau = rng.uniform(0.02, 0.09, (m, q)) if het else SLO
    return dict(m=m, q=q, n=n, het=het, clip=clip, w=w, mask=mask, lat=lat,
                bat=bat, queue=queue, tau=tau)


def _device_args(case, device):
    import torch

    f32 = (lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(device))
    i32 = (lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.int32)).to(device))
    tau = case["tau"]
    return ((f32(case["w"]), f32(case["mask"]),
             torch.from_numpy(case["lat"]).to(device), i32(case["bat"]),
             None if case["n"] is None else i32(case["queue"])),
            dict(tau=f32(tau) if np.ndim(tau) == 2 else float(tau),
                 clip=case["clip"]))


def _bound(m, q, n):
    nbytes = 3 * m * q * 4 + n * (4 + 4 + 4) + n * 4
    ops = OPS_PER_ELEMENT * n * m * q
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(device):
    import torch

    from repro_torch.core.scoring import NumpyScoringBackend
    from repro_torch.device import synchronize
    from repro_torch.kernels.stability_score.ops import stability_scores
    from repro_torch.kernels.stability_score.ref import stability_scores_plain

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    f64 = NumpyScoringBackend()
    shapes = ([(3, q, None) for q in (1, 7, 64)] + [(3, 32, 12)]
              + [(256, 128, 1024)])
    max_abs = max_rel = 0.0
    n_cases = argmin_ties = 0
    for m, q, n in shapes:
        for het in (False, True):
            for clip in (10.0, 3.0):
                case = _kernel_case(rng, m, q, n, het, clip)
                args, kw = _device_args(case, dev)
                got = stability_scores(*args, **kw)
                synchronize(dev)
                want = stability_scores_plain(*args, **kw)
                g, p = got.cpu().numpy(), want.cpu().numpy()
                check(g.shape == (m if n is None else n,),
                      f"kernel output shape {g.shape}")
                check(np.all(np.isfinite(g)), "kernel output not finite")
                err = np.abs(g.astype(np.float64) - p)
                max_abs = max(max_abs, float(err.max()))
                max_rel = max(max_rel, float((err / np.abs(p)).max()))
                check(np.allclose(g, p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
                      f"kernel disagrees with plain at M={m} Q={q} N={n} "
                      f"het={het} C={clip}: max abs err {err.max()}")
                ref = f64.score(case["w"], case["mask"], case["lat"],
                                case["bat"], case["queue"], case["tau"], clip)
                a, b = int(np.argmin(g)), int(np.argmin(ref))
                if a != b:
                    tie = abs(ref[a] - ref[b]) <= TIE_RTOL * abs(ref[b])
                    check(tie, f"argmin {a} != float64 argmin {b} at M={m} "
                               f"Q={q} N={n} het={het} C={clip}")
                    argmin_ties += 1
                n_cases += 1

    timings = {}
    for label, (m, q, n) in (("m3", (3, 64, None)), ("m256", (256, 128, 1024))):
        case = _kernel_case(rng, m, q, n, False, 10.0)
        args, kw = _device_args(case, dev)
        iters = 200 if m == 3 else 50
        timings[label] = dict(
            M=m, Q=q, N=m if n is None else n,
            ms=graph_ms(lambda: stability_scores(*args, **kw), iters),
            eager_ms=cuda_ms(lambda: stability_scores(*args, **kw), iters),
            plain_ms=cuda_ms(lambda: stability_scores_plain(*args, **kw),
                             iters))
        timings[label]["bound_ms"], timings[label]["bound_by"] = _bound(
            m, q, m if n is None else n)
    emit("kernel", cases=n_cases, max_abs_err=max_abs, max_rel_err=max_rel,
         rtol=KERNEL_RTOL, atol=KERNEL_ATOL, argmin_ties=argmin_ties,
         timings=timings)
    return dict(max_abs_err=max_abs, max_rel_err=max_rel, timings=timings)


# ---------------------------------------------------------------------------
# Phase 3: the full-width ResNets on the card against the CPU
# ---------------------------------------------------------------------------


def phase_models(configs, device):
    import torch

    from repro_torch.models import EarlyExitResNet
    from repro_torch.runtime.server import serve_resnets

    t0 = time.perf_counter()
    served = serve_resnets(configs, device=device, seed=0, max_batch=10)
    build_s = time.perf_counter() - t0
    errs = {}
    for mod in served:
        twin = EarlyExitResNet(configs[mod.name], device="cpu").eval()
        twin.load_state_dict(mod.values.state_dict())
        x = mod.data_fn(2)
        for e in range(mod.num_exits):
            with torch.inference_mode():
                got = mod.values.forward_exit(x, e).cpu()
                want = twin.forward_exit(x.cpu(), e)
            check(tuple(got.shape) == (2, 100),
                  f"{mod.name} exit {e} shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()),
                  f"{mod.name} exit {e} not finite")
            check(torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL),
                  f"{mod.name} exit {e}: card and CPU differ by "
                  f"{float((got - want).abs().max())}")
            errs[f"{mod.name}/exit{e}"] = float((got - want).abs().max())
        del twin
    params = {mod.name: sum(p.numel() for p in mod.values.parameters())
              for mod in served}
    emit("models", build_seconds=build_s, params=params,
         max_abs_err_vs_cpu=errs, tol=MODEL_TOL,
         tf32=[torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32])
    return served


# ---------------------------------------------------------------------------
# Phase 4: live serving
# ---------------------------------------------------------------------------


class RecordingScheduler:
    """Delegates to a scheduler and keeps every (snapshot, decision) round,
    so a shadow scheduler can decide on the same snapshots afterwards."""

    def __init__(self, inner):
        self.inner = inner
        self.rounds = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def decide(self, snapshot):
        d = self.inner.decide(snapshot)
        self.rounds.append((snapshot, d))
        return d


def _score_of(sched, snapshot, model):
    """float64 score of queue ``model``'s Eq. 5/6 candidate."""
    cq, cb, _, cl, _ = sched.enumerate_candidates(snapshot)
    scores = sched.score_candidates(snapshot, cl, cb, cq)
    return float(scores[list(cq).index(model)])


def phase_serving(served, device):
    from repro_torch.core import (
        SchedulerConfig,
        VectorizedEdgeServingScheduler,
        make_scheduler,
        paper_rate_vector,
        poisson_arrivals,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime.server import (
        ServingEngine,
        measure_profile,
        run_quantum,
    )

    # one untimed pass over every cell first: the card's clocks ramp up
    # under load, and the first cells of a cold card would read slow
    for mod in served:
        for e in range(mod.num_exits):
            for b in range(1, 11):
                run_quantum(mod, e, b)
    clocks_before = smi("clocks.sm,power.draw")
    t0 = time.perf_counter()
    table = measure_profile(
        served, batch_sizes=range(1, 11),
        exit_names=("layer1", "layer2", "layer3", "final"),
        repeats=10, warmup=2)
    profile_s = time.perf_counter() - t0
    clocks_after = smi("clocks.sm,power.draw")
    lat_ms = table.latency * 1e3
    emit("profile", seconds=profile_s, platform=table.meta["platform"],
         sm_clock_power=[clocks_before, clocks_after],
         cells=int(table.latency.size),
         b1_ms={f"{table.model_names[m]}/{table.exit_names[e]}":
                float(lat_ms[m, e, 0]) for m in range(3) for e in range(4)},
         b10_ms={f"{table.model_names[m]}/{table.exit_names[e]}":
                 float(lat_ms[m, e, -1]) for m in range(3) for e in range(4)})
    check(table.latency.shape == (3, 4, 10), "profile table shape")

    cfg = SchedulerConfig(slo=SLO, max_batch=10, backend="cuda",
                          device=device)
    sched = RecordingScheduler(make_scheduler("edgeserving", table, cfg))
    engine = ServingEngine(served, sched)
    engine.warmup()
    arrivals = poisson_arrivals(paper_rate_vector(LAMBDA_152), HORIZON_S,
                                seed=0)
    reset_launch_counts()
    completions, span = engine.run(arrivals, HORIZON_S, drain=True)
    launches = launch_counts["stability_score"]
    m = engine.metrics(table, SLO, span)
    scored = [(s, d) for s, d in sched.rounds if s.nonempty()]
    residual = m.residual_queue
    emit("serve", arrivals=len(arrivals), completed=len(completions),
         dropped=engine.dropped, residual=residual, span_s=span,
         p95_ms=m.p95_latency * 1e3, p50_ms=m.p50_latency * 1e3,
         violation_ratio=m.violation_ratio,
         mean_exit_depth=m.mean_exit_depth, utilization=m.utilization,
         throughput=m.throughput, mean_batch=m.mean_batch,
         rounds=len(sched.rounds), scoring_rounds=len(scored),
         kernel_launches=launches,
         mean_max_q=float(np.mean([max(s.qlens()) for s, _ in scored])),
         per_model=[dict(model=pm.model, completed=pm.num_completed,
                         violation_ratio=pm.violation_ratio,
                         p95_ms=pm.p95_latency * 1e3,
                         mean_exit_depth=pm.mean_exit_depth)
                    for pm in m.per_model])
    check(len(completions) + engine.dropped + residual == len(arrivals),
          "arrivals not conserved")
    check(len(scored) > 0, "no scoring round ran")
    check(launches == len(scored),
          f"kernel launches {launches} != scoring rounds {len(scored)}")

    shadow = make_scheduler("edgeserving", table,
                            SchedulerConfig(slo=SLO, max_batch=10))
    vec64 = VectorizedEdgeServingScheduler(
        table, SchedulerConfig(slo=SLO, max_batch=10))
    mismatches = ties = 0
    for snap, d in scored:
        ds = shadow.decide(snap)
        if (d.model, d.exit_idx, d.batch_size) == (
                ds.model, ds.exit_idx, ds.batch_size):
            continue
        s_card = _score_of(vec64, snap, d.model)
        s_host = _score_of(vec64, snap, ds.model)
        if abs(s_card - s_host) <= TIE_RTOL * abs(s_host):
            ties += 1
        else:
            mismatches += 1
    emit("shadow", rounds=len(scored), mismatches=mismatches,
         float32_ties=ties)
    check(mismatches == 0, f"{mismatches} decisions differ from the numpy "
                           f"shadow beyond float32 ties")

    # per-round decision time on the recorded snapshots, host clock
    cuda_sched = make_scheduler("edgeserving", table, cfg)
    sample = [s for s, _ in scored][:500]
    timing = {}
    for name, sc in (("numpy", shadow), ("cuda", cuda_sched)):
        for s in sample[:20]:
            sc.decide(s)
        per = []
        for s in sample:
            t = time.perf_counter()
            sc.decide(s)
            per.append(time.perf_counter() - t)
        timing[name] = dict(mean_us=float(np.mean(per)) * 1e6,
                            p50_us=float(np.median(per)) * 1e6)
    emit("decision_time", snapshots=len(sample), **timing)
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "stability_score.cu").exists():
        print(f"chip_smoke: no port sources under {SRC}; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import FULL

    phase_device_and_build()
    kernel = phase_kernel("cuda")
    served = phase_models(FULL, "cuda")
    launches = phase_serving(served, "cuda")
    t3 = kernel["timings"]["m3"]
    t256 = kernel["timings"]["m256"]
    print(json.dumps({"kernels": [{
        "name": "stability_score",
        "route": "cuda",
        "source": "src/repro_torch/csrc/stability_score.cu",
        "replaces": "src/repro/kernels/stability_score/kernel.py:35",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "max_rel_err": kernel["max_rel_err"],
        "ms": t3["ms"],
        "eager_ms": t3["eager_ms"],
        "plain_ms": t3["plain_ms"],
        "bound_ms": t3["bound_ms"],
        "bound_by": t3["bound_by"],
        "library_ms": None,
        "ms_m256": t256["ms"],
        "eager_ms_m256": t256["eager_ms"],
        "plain_ms_m256": t256["plain_ms"],
        "bound_ms_m256": t256["bound_ms"],
        "bound_by_m256": t256["bound_by"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
