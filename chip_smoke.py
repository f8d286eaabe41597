#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It drives the port's live paths end to end, the paper's ResNets and the
early-exit LMs (served quanta and KV-cache decode):

1. device and build: the card's name and power limit, the five CUDA kernels
   built from ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a`` in one
   parallel round (with each one's ptxas report), TF32 off;
2. the stability-score kernel against its plain PyTorch version on the card
   (greedy, lattice and many-queue shapes, each of the kernel's layouts,
   ragged N; scalar and per-task tau; two clips), its argmin against the
   float64 numpy backend, and its time through the wrapper and alone;
3. the LM kernels (rmsnorm, flash attention, the fused exit head, decode
   attention) against their plain versions on the card at every served
   model's shapes (rmsnorm also at a decode step's rows, and Qwen3's q and
   k rows in one ``rmsnorm_pair`` launch), in bfloat16 and
   float32, ragged S and V included, and decode attention at the edges of
   its lengths; their times (CUDA-graph replay; rmsnorm's also with its
   inputs out of L2) beside the bound, the plain version and the library
   call (flash attention in both dtypes: bfloat16
   runs on the tensor cores, float32 on the CUDA cores); each exit-head
   case names the first pass it ran (``tensor_core`` or ``cuda_core``) and
   carries the bare [T, D] x [D, V] product's time for information;
4. the full-width early-exit ResNet-50/101/152 on the card against the same
   modules on the CPU at every exit;
5. live ResNet serving: ``measure_profile`` over the 120-cell table, then
   the EdgeServing scheduler with the ``cuda`` scoring backend serving the
   paper's fig4 knee (lambda_152 = 140 req/s at 3:2:1, 3 s, drained), with a
   float64 numpy shadow scheduler on the same snapshots; the per-round
   decision time of both, a ``cuda`` round's host split (pack, upload,
   launch, fetch and synchronise), and one round of each backend at
   M = 256, N = 1024;
6. the LMs on the card against the CPU in float32: SmolLM-135M at full
   width and depth at every exit, Phi-4-mini and Qwen3-8B at full width cut
   to 2 layers and one exit;
7. KV-cache decode on the card against the CPU in float32, the same models
   and cuts: prefill, then 16 teacher-forced decode steps; logits and
   caches against the CPU's, logits against ``forward_exit``;
8. live LM serving: SmolLM-135M, Phi-4-mini and Qwen3-8B at full width and
   depth in bfloat16, ``measure_profile`` over 3 x 4 x 4 cells, then a 3 s
   Poisson trace at 3:2:1 whose total rate keeps the card 90% busy at the
   final exit and B = 8, served with the ``cuda`` scoring backend and the
   float64 shadow; each LM kernel's launches must equal the count implied
   by the engine's decisions;
9. KV-cache decode of the same three models in bfloat16: B = 1 and 8 at the
   first and final exit, 32 greedy steps after the 128-token prompt; step
   time on the host, device time by kernel class, idle share, peak memory;
   decode-attention and rmsnorm launches must equal the count the steps
   imply, and the profiled step must run one decode-attention kernel a
   layer;
10. the kernel summary line, then ``{"ok": true, ...}`` as the last line.

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

# The card's published peaks (H100 SXM data sheet): HBM rate, float32
# (non-tensor-core) rate and the dense bfloat16 tensor-core rate, for a
# kernel's least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
L2_BYTES = 50 << 20  # the H100's L2
KERNELS = ("stability_score", "rmsnorm", "flash_attention", "exit_head",
           "decode_attention")
OPS_PER_ELEMENT = 8   # add, div, sub, min, exp, min, mul, add per (n, task)

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
MODEL_TOL = 1e-3
TIE_RTOL = 1e-6
SLO = 0.050
LAMBDA_152 = 140.0
HORIZON_S = 3.0
# tests/test_kernels.py:22-23; the float32 one also holds the LMs' card
# against their CPU runs (the reference's model tests use it)
LM_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
LM_ARCHS = ("smollm-135m", "phi4-mini-3.8b", "qwen3-8b")
LM_PROMPT = 128
LM_BATCHES = (1, 2, 4, 8)
LM_BUSY = 0.9       # card share kept busy at the final exit and B = 8
DECODE_MAX_LEN = 160  # the decode cache: the 128-token prompt + 32 tokens
DECODE_STEPS = 32
DECODE_CHECK = dict(prompt=16, steps=16, max_len=40)  # the float32 check
# torch.profiler now and then loses a few kernel events of a step (2 of a
# Qwen3 step's 36 decode-attention kernels in one of eight runs on an H100):
# a trace that holds fewer decode-attention kernels than the step ran is
# taken again, on the next step, up to this many times, and is let go only
# where kernels of another class went missing from it too
PROFILE_TRIES = 3
# (kernel, case) also timed in float32: flash attention has a tensor-core
# kernel for bfloat16 and a CUDA-core one for float32
F32_TIMED = {("flash_attention", f"{LM_ARCHS[-1]}/prefill")}


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


def cold_graph_ms(fn, args, iters: int = 10, copies_max: int = 2048) -> float:
    """Device time of one ``fn`` call on inputs that are not in L2:
    ``graph_ms`` over copies of ``args`` taken in turn, enough of them to
    fill twice the L2 (at most ``copies_max``), each call's output kept
    apart too. Rows so small that ``copies_max`` copies fill less are read
    partly from L2 all the same."""
    import itertools

    nbytes = sum(a.numel() * a.element_size() for a in args)
    copies = min(copies_max, max(2, -(-2 * L2_BYTES // nbytes)))
    sets = itertools.cycle([tuple(a.clone() for a in args)
                            for _ in range(copies)])
    outs = []  # held until the replays end: each call writes its own
    return graph_ms(lambda: outs.append(fn(*next(sets))), iters,
                    per_graph=copies)


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
    paths = build.build(list(KERNELS))
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.BUILD_LOG.get(
        name, {}).get("ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln or "entry function" in ln]
        for name in KERNELS}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("build", card=card, torch=torch.__version__,
         cuda=torch.version.cuda,
         libraries={n: p.name for n, p in paths.items()},
         build_seconds=seconds,
         per_kernel_seconds={n: build.BUILD_LOG.get(n, {}).get("seconds")
                             for n in KERNELS},
         ptxas=ptxas)
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
    # the greedy and lattice rounds (one warp a candidate, up to the
    # 4096-task edge), then K = 1, 2, 4 and 8 candidates a tiled block
    # (ragged N: 1021 leaves a tail of 5)
    shapes = ([(3, q, None) for q in (1, 7, 64)] + [(3, 32, 12)]
              + [(16, 256, 300), (64, 96, 37), (17, 257, 300),
                 (40, 128, 600), (256, 128, 1024), (256, 128, 1021)])
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

    # ms, eager_ms, plain_ms: float64 latencies through the wrapper (a cast
    # kernel, then the kernel), as every run since the first has timed it;
    # kernel_ms: the kernel alone, on the float32 latencies the ``cuda``
    # backend hands it
    timings = {}
    for label, (m, q, n) in (("m3", (3, 64, None)), ("m256", (256, 128, 1024))):
        case = _kernel_case(rng, m, q, n, False, 10.0)
        args, kw = _device_args(case, dev)
        lat32 = (*args[:2], args[2].float(), *args[3:])
        iters = 200 if m == 3 else 50
        timings[label] = dict(
            M=m, Q=q, N=m if n is None else n,
            ms=graph_ms(lambda: stability_scores(*args, **kw), iters),
            kernel_ms=graph_ms(lambda: stability_scores(*lat32, **kw), iters),
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
# Phase 4: the full-width ResNets on the card against the CPU
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
# Phase 5: live ResNet serving
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


def shadow_check(phase, scored, table, max_batch):
    """Decide every recorded snapshot again with the float64 numpy
    EdgeServing scheduler; a decision that differs must be a float32 tie.
    Returns the numpy scheduler."""
    from repro_torch.core import (
        SchedulerConfig,
        VectorizedEdgeServingScheduler,
        make_scheduler,
    )

    shadow = make_scheduler("edgeserving", table,
                            SchedulerConfig(slo=SLO, max_batch=max_batch))
    vec64 = VectorizedEdgeServingScheduler(
        table, SchedulerConfig(slo=SLO, max_batch=max_batch))
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
    emit(phase, rounds=len(scored), mismatches=mismatches,
         float32_ties=ties)
    check(mismatches == 0, f"{mismatches} decisions differ from the numpy "
                           f"shadow beyond float32 ties")
    return shadow


def phase_serving(served, device, scoring_round=None):
    """The fig4 knee served live, its decisions held against the numpy
    shadow and their decision time, then ``scoring_round`` (by default
    ``phase_scoring_round``) given a ``cuda`` scheduler and the recorded
    snapshots. Returns the stability kernel's launches."""
    from repro_torch.core import (
        SchedulerConfig,
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

    shadow = shadow_check("shadow", scored, table, max_batch=10)

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
    (scoring_round or phase_scoring_round)(cuda_sched, sample)
    return launches


def fig4_rounds(sched, sample):
    """The scoring inputs of each recorded fig4 snapshot's candidates: (w,
    mask, latency, batch, queue); the SLO is the scheduler's scalar."""
    rounds = []
    for s in sample:
        check(not s.has_deadlines, "fig4 snapshots carry no deadlines")
        cq, cb, _, cl, _ = sched.enumerate_candidates(s)
        rounds.append((*s.padded(), cl, cb, cq))
    return rounds


def staged_round_split(backend, w, mask, cl, cb, cq, slo, clip):
    """Host-clock seconds of each of the ``cuda`` backend's four steps on
    one round: pack; upload, one non-blocking copy; launch; fetch, one copy
    that synchronises the stream."""
    t0 = time.perf_counter()
    layout = backend.pack(w, mask, cl, cb, cq, slo)
    t1 = time.perf_counter()
    backend.upload(layout)
    t2 = time.perf_counter()
    backend.launch(layout, slo, clip)
    t3 = time.perf_counter()
    backend.fetch(layout)
    t4 = time.perf_counter()
    return dict(pack=t1 - t0, upload=t2 - t1, launch=t3 - t2,
                fetch_sync=t4 - t3)


def mean_split_us(per):
    """The mean of each step over the rounds, and their sum, in us."""
    split = {k: float(np.mean([p[k] for p in per])) * 1e6 for k in per[0]}
    split["total"] = float(sum(split.values()))
    return split


def phase_scoring_round(sched, sample):
    """Where a ``cuda`` scoring round's host time goes, on the recorded
    fig4 snapshots (scalar SLO): the backend's four steps timed apart with
    the host clock (``staged_round_split``; means in us). Then one round of
    the ``numpy`` and one of the ``cuda`` backend at M = 256, Q = 128,
    N = 1024 (median of 5 each), whose decisions must agree."""
    from repro_torch.core.scoring import NumpyScoringBackend

    backend, slo, clip = sched.scoring, sched.config.slo, sched.config.clip
    rounds = fig4_rounds(sched, sample)
    for _ in range(2):  # the first pass warms up
        per = [staged_round_split(backend, *r, slo, clip) for r in rounds]
    split = mean_split_us(per)

    case = _kernel_case(np.random.default_rng(1), 256, 128, 1024, False, clip)
    args = (case["w"], case["mask"], case["lat"], case["bat"], case["queue"],
            slo, clip)
    m256, picks = {}, {}
    for name, be in (("numpy", NumpyScoringBackend()), ("cuda", backend)):
        scores = be.score(*args)
        per = []
        for _ in range(5):
            t0 = time.perf_counter()
            be.score(*args)
            per.append(time.perf_counter() - t0)
        m256[name] = float(np.median(per)) * 1e6
        picks[name] = (int(np.argmin(scores)), scores)
    (a, _), (b, ref) = picks["cuda"], picks["numpy"]
    check(a == b or abs(ref[a] - ref[b]) <= TIE_RTOL * abs(ref[b]),
          f"cuda round at M=256 picks {a}, numpy {b}")
    emit("scoring_round", snapshots=len(rounds), mean_us=split,
         m256_us=dict(M=256, Q=128, N=1024, **m256))


# ---------------------------------------------------------------------------
# Phase 3: the LM kernels against their plain versions
# ---------------------------------------------------------------------------


def _rate(dtype, matrix: bool) -> float:
    """Peak operations per second for work on ``dtype`` inputs: a matrix
    product on bfloat16 inputs may use the tensor cores; anything else runs
    on the float32 units."""
    import torch

    return (PEAK_BF16_OPS_PER_S if matrix and dtype == torch.bfloat16
            else PEAK_F32_OPS_PER_S)


def _bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _lm_kernel_cases(configs):
    """(kernel, label, shape) at every served model's shapes (B = 8, S =
    128; the exit head at every batch of the ladder; decode attention at
    B = 1 and 8 over the 160-slot decode cache; rmsnorm also at a decode
    step's rows, T = B = 1 and 8, and q/k rows B x H; the q/k pair, whose
    shape is (T_q, T_k, D), at the prefill and decode rows), ragged S and V,
    one
    long prompt (B = 1, S = 2048) and one long decode cache (B = 8, S = 4096)
    of the last model's attention; for flash attention also the last
    model's B = 1 prefill (the B = 1 quanta), a block boundary (S = 129)
    and a non-causal case. An attention shape is (B, H, K, S, D, causal).
    A decode shape is (B, H, K, S, D, cache layout): 1 for the model's
    views (q of ``[B, 1, H, D]``, k and v of a ``[B, S, K, D]`` cache), 0
    for contiguous ``[B, K, S, D]``."""
    b, s = LM_BATCHES[-1], LM_PROMPT
    cases = []
    for arch, cfg in configs.items():
        heads = (cfg.num_heads, cfg.num_kv_heads)
        for db in (1, b):
            cases.append(("decode_attention",
                          f"{arch}/served" + ("" if db == b else f"_b{db}"),
                          (db, *heads, DECODE_MAX_LEN, cfg.head_dim_, 1)))
        dh = cfg.head_dim_
        cases.append(("rmsnorm", f"{arch}/residual", (b * s, cfg.d_model)))
        if cfg.qk_norm:
            cases.append(("rmsnorm", f"{arch}/qk",
                          (b * s * cfg.num_heads, dh)))
            cases.append(("rmsnorm", f"{arch}/qk_pair",
                          (b * s * cfg.num_heads, b * s * cfg.num_kv_heads,
                           dh)))
        for db in (1, b):  # a decode step's rows: T = B
            cases.append(("rmsnorm", f"{arch}/decode_t{db}",
                          (db, cfg.d_model)))
            if cfg.qk_norm:
                cases.append(("rmsnorm", f"{arch}/qk_decode_b{db}",
                              (db * cfg.num_heads, dh)))
                cases.append(("rmsnorm", f"{arch}/qk_pair_decode_b{db}",
                              (db * cfg.num_heads, db * cfg.num_kv_heads,
                               dh)))
        cases.append(("flash_attention", f"{arch}/prefill",
                      (b, cfg.num_heads, cfg.num_kv_heads, s, dh, True)))
        cases.append(("flash_attention", f"{arch}/ragged_s77",
                      (2, cfg.num_heads, cfg.num_kv_heads, 77, dh, True)))
        for t in LM_BATCHES:
            cases.append(("exit_head",
                          f"{arch}/served" + ("" if t == b else f"_t{t}"),
                          (t, cfg.d_model, cfg.vocab_size)))
        cases.append(("exit_head", f"{arch}/t3_ragged_v",
                      (3, cfg.d_model, cfg.vocab_size - 5)))
    cases.append(("rmsnorm", "ragged_t1000", (1000, 4096)))
    last = list(configs.values())[-1]
    heads = (last.num_heads, last.num_kv_heads)
    cases.append(("flash_attention", "long_prompt_s2048",
                  (1, *heads, 2048, last.head_dim_, True)))
    cases.append(("flash_attention", f"{LM_ARCHS[-1]}/prefill_b1",
                  (1, *heads, s, last.head_dim_, True)))
    cases.append(("flash_attention", "boundary_s129",
                  (2, *heads, 129, last.head_dim_, True)))
    cases.append(("flash_attention", "noncausal_s128",
                  (2, *heads, s, last.head_dim_, False)))
    cases.append(("decode_attention", "long_cache_s4096",
                  (b, *heads, 4096, last.head_dim_, 1)))
    cases.append(("decode_attention", "contiguous_s160",
                  (b, *heads, DECODE_MAX_LEN, last.head_dim_, 0)))
    first = list(configs.values())[0]
    cases.append(("decode_attention", "ragged_s77",
                  (3, first.num_heads, first.num_kv_heads, 77,
                   first.head_dim_, 0)))
    cases.append(("decode_attention", "ragged_s1000",
                  (2, *heads, 1000, last.head_dim_, 1)))
    return cases


def _lm_kernel_inputs(kernel, shape, dtype, device, gen):
    import torch

    def randn(*size, scale=1.0, shift=0.0):
        x = torch.randn(size, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale + shift).to(dtype)

    if kernel == "rmsnorm":
        *rows, d = shape  # (T, D), or (T_q, T_k, D) for the q/k pair
        return sum(((randn(t, d, scale=3.0), randn(d, scale=0.2, shift=1.0))
                    for t in rows), ())
    if kernel == "flash_attention":
        b, h, kh, s, d, causal = shape
        return (randn(b, h, s, d), randn(b, kh, s, d), randn(b, kh, s, d),
                causal)
    if kernel == "decode_attention":
        b, h, kh, s, d, cache_layout = shape
        if cache_layout:
            q = randn(b, 1, h, d)[:, 0]
            k, v = (randn(b, s, kh, d).transpose(1, 2) for _ in range(2))
        else:
            q, k, v = randn(b, h, d), randn(b, kh, s, d), randn(b, kh, s, d)
        # ragged rows in [1, S], the last one full
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=device,
                             dtype=torch.int32)
        lens[-1] = s
        return q, k, v, lens
    t, d, v = shape
    return (randn(t, d), randn(d, scale=0.1, shift=1.0),
            randn(d, v, scale=d ** -0.5))


def _lm_kernel_cost(kernel, shape, dtype, args=None):
    """(bytes, operations, rate) of one call: each input read once, each
    output written once; causal attention counted at half the square
    (the float32 kernel's rate is the float32 units', the bfloat16 one's
    the tensor cores');
    decode attention over this call's valid prefixes only (``args``' lengths,
    clamped to S): K/V read once, 4 D operations per (query head,
    position)."""
    import torch

    el = torch.tensor([], dtype=dtype).element_size()
    if kernel == "rmsnorm":
        *rows, d = shape
        t = sum(rows)
        return (2 * t * d + len(rows) * d) * el, 4 * t * d, _rate(dtype, False)
    if kernel == "flash_attention":
        b, h, kh, s, d, causal = shape
        nbytes = (2 * b * h * s * d + 2 * b * kh * s * d) * el
        ops = 4 * b * h * s * s * d / (2 if causal else 1)
        return nbytes, ops, _rate(dtype, True)
    if kernel == "decode_attention":
        b, h, kh, s, d, _ = shape
        valid = float(args[3].clamp(0, s).sum())
        nbytes = (2 * valid * kh * d + 2 * b * h * d) * el + 4 * b
        return nbytes, 4 * valid * h * d, _rate(dtype, True)
    t, d, v = shape
    return ((t * d + d + d * v) * el + t * 12, 2 * t * d * v,
            _rate(dtype, True))


def _lm_library(kernel, args):
    """One PyTorch call computing the same function, timed as the yardstick
    (the port never calls it); None where there is none."""
    import torch
    import torch.nn.functional as F

    if kernel == "rmsnorm":
        if len(args) != 2:
            return None  # the q/k pair: no one call normalises two tensors
        x, g = args
        return lambda: F.rms_norm(x, (x.shape[-1],), weight=g, eps=1e-6)
    if kernel == "flash_attention":
        q, k, v, causal = args
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    if kernel == "decode_attention":
        q, k, v, lens = args
        keep = (torch.arange(k.shape[2], device=k.device)[None, :]
                < lens[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=keep, enable_gqa=True)
    return None


def _lm_compare(kernel, args, got, want, dtype_name, label):
    """Max abs error of kernel against plain; raises beyond the tolerance.
    The exit head's max and lse are float32 outputs in either input dtype
    and are held at the float32 tolerance; its token must equal the plain
    argmax in float32, and in bfloat16 equal it or score within that
    tolerance of the plain maximum."""
    import torch

    from repro_torch.kernels.exit_head.ref import exit_head_logits

    tol = LM_TOL[dtype_name]
    if kernel == "exit_head":
        tol = LM_TOL["float32"]
        pairs = list(zip(got[1:], want[1:]))
        if dtype_name == "float32":
            check(torch.equal(got[0].cpu(), want[0].cpu()),
                  f"exit_head {label} float32 argmax differs from plain")
        else:
            picked = exit_head_logits(*args).gather(
                1, got[0].long()[:, None])[:, 0]
            check(bool(torch.all((got[0] == want[0]) |
                                 (want[1] - picked <= tol))),
                  f"exit_head {label} {dtype_name}: token "
                  f"{got[0].tolist()} vs plain {want[0].tolist()}")
    else:
        pairs = (list(zip(got, want)) if isinstance(got, tuple)
                 else [(got, want)])
    err = 0.0
    for g, w in pairs:
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{kernel} {label} not finite")
        check(torch.allclose(g, w, rtol=tol, atol=tol),
              f"{kernel} {label} {dtype_name}: max abs err "
              f"{float((g - w).abs().max())} beyond {tol}")
        err = max(err, float((g - w).abs().max()))
    return err


def _decode_edge_checks(cfg, dev, gen):
    """Decode attention at the edges of its lengths, in both dtypes, with
    ``cfg``'s heads over a ragged S = 77 cache: length 1 and a length past S
    against the plain version; K/V past a row's length set to +-1e4 change
    nothing (``test_cache_tail_is_ignored``); on the card, length 0 gives 0
    as the Pallas kernel does (the plain version follows the reference's
    oracle there). Returns {dtype: max abs err}."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain,
    )

    s, errs = 77, {}
    shape = (4, cfg.num_heads, cfg.num_kv_heads, s, cfg.head_dim_, 1)
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        q, k, v, _ = _lm_kernel_inputs("decode_attention", shape, dtype, dev,
                                       gen)
        lens = torch.tensor([1, s + 5, 30, 0], dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, lens)
        synchronize(dev)
        errs[dname] = _lm_compare(
            "decode_attention", None, got[:3],
            decode_attention_plain(q, k, v, lens)[:3], dname, "lengths")
        if dev.type == "cuda":
            check(not bool(got[3].any()), f"decode_attention {dname}: "
                  f"length 0 gave {float(got[3].abs().max())}, not 0")
        k2, v2 = k.clone(), v.clone()
        k2[2, :, 30:], v2[2, :, 30:] = 1e4, -1e4
        k2[0, :, 1:], v2[0, :, 1:] = 1e4, -1e4
        tail = decode_attention(q, k2, v2, lens)
        check(torch.equal(tail[:3:2], got[:3:2]),
              f"decode_attention {dname}: K/V past the length changed the "
              f"result by {float((tail[:3:2] - got[:3:2]).abs().max())}")
    return errs


def phase_lm_kernels(configs, device):
    """Every LM kernel against its plain version at the served shapes, in
    bfloat16 and float32; bfloat16 times at each shape, and float32 times
    at the shapes of ``F32_TIMED`` (keyed ``<label>/float32``)."""
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain,
    )
    from repro_torch.kernels.exit_head.ops import exit_head, exit_head_path
    from repro_torch.kernels.exit_head.ref import exit_head_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_pair
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    from repro_torch.device import synchronize

    def attention(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal)

    def norm(*args):  # one tensor, or the q/k pair
        return rmsnorm(*args) if len(args) == 2 else rmsnorm_pair(*args)

    def norm_plain(*args):
        return (rmsnorm_plain(*args) if len(args) == 2 else
                (rmsnorm_plain(*args[:2]), rmsnorm_plain(*args[2:])))

    wrappers = {"rmsnorm": (norm, norm_plain),
                "flash_attention": (attention, flash_attention_plain),
                "exit_head": (exit_head, exit_head_plain),
                "decode_attention": (decode_attention,
                                     decode_attention_plain)}
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in wrappers}
    timings = {k: {} for k in wrappers}
    for kernel, label, shape in _lm_kernel_cases(configs):
        fn, plain = wrappers[kernel]
        for dname, dtype in dtypes.items():
            args = _lm_kernel_inputs(kernel, shape, dtype, dev, gen)
            got = fn(*args)
            synchronize(dev)
            want = plain(*args)
            errs[kernel][dname] = max(errs[kernel][dname], _lm_compare(
                kernel, args, got, want, dname, label))
            if dname != "bfloat16" and (kernel, label) not in F32_TIMED:
                continue
            nbytes, ops, rate = _lm_kernel_cost(kernel, shape, dtype, args)
            bound, bound_by = _bound_ms(nbytes, ops, rate)
            lib = _lm_library(kernel, args)
            key = label if dname == "bfloat16" else f"{label}/{dname}"
            timings[kernel][key] = dict(
                shape=list(shape), dtype=dname,
                ms=graph_ms(lambda: fn(*args), 20),
                plain_ms=cuda_ms(lambda: plain(*args), 5),
                library_ms=None if lib is None else cuda_ms(lib, 20),
                bound_ms=bound, bound_by=bound_by)
            if kernel == "rmsnorm":
                # the replay above reads rows of up to 10 MB from L2
                timings[kernel][key]["cold_ms"] = cold_graph_ms(fn, args)
            if kernel == "exit_head":
                # which first pass ran, and the bare [T, D] x [D, V]
                # product, for information only (no yardstick: it returns
                # the logits, not their argmax, max and logsumexp)
                h, _, w = args
                timings[kernel][key].update(
                    path=exit_head_path(h, w),
                    matmul_ms=cuda_ms(lambda: torch.matmul(h, w), 20))
            del got, want, args
    if dev.type == "cuda":
        # ties across the exit head's tile boundaries go to the first index
        for dtype in dtypes.values():
            h = torch.ones((2, 16), dtype=dtype, device=dev)
            w = torch.zeros((16, 1024), dtype=dtype, device=dev)
            w[:, [127, 128, 255, 256]] = 1.0
            idx = exit_head(h, torch.ones(16, dtype=dtype, device=dev), w)[0]
            check(idx.tolist() == [127, 127],
                  f"exit_head ties: {idx.tolist()} != [127, 127]")
    for dname, err in _decode_edge_checks(list(configs.values())[-1], dev,
                                          gen).items():
        errs["decode_attention"][dname] = max(
            errs["decode_attention"][dname], err)
    emit("lm_kernels", max_abs_err=errs, tol=LM_TOL, timings=timings)
    return dict(errs=errs, timings=timings)


# ---------------------------------------------------------------------------
# Phase 6: the LMs on the card against the CPU, float32
# ---------------------------------------------------------------------------


def _lm_outputs(model, tokens, exits):
    """{exit: (forward_exit logits, exit_decision's (token, max, lse))} on
    the CPU."""
    import torch

    dev = model.embed.device
    out = {}
    with torch.inference_mode():
        for e in exits:
            batch = {"tokens": tokens.to(dev)}
            out[e] = (model.forward_exit(batch, e).cpu(),
                      tuple(x.cpu() for x in model.exit_decision(batch, e)))
    return out


def _lm_check_pair(model, batch_size, seq, exits, label):
    """forward_exit logits and exit_decision of the model on its device
    (the kernels) against the same model moved to the CPU (the plain
    versions) at each exit; returns {exit: max abs err}."""
    import torch

    cfg = model.cfg
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq),
                           generator=gen)
    card = _lm_outputs(model, tokens, exits)
    host = _lm_outputs(model.to("cpu"), tokens, exits)
    tol = LM_TOL["float32"]
    errs = {}
    for e in exits:
        got, (g_idx, g_mx, g_lse) = card[e]
        want, (w_idx, w_mx, w_lse) = host[e]
        check(got.shape == (batch_size, seq, cfg.vocab_padded),
              f"{label} exit {e} shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{label} exit {e} not finite")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=tol, atol=tol),
              f"{label} exit {e}: card and CPU logits differ by {err}")
        for a, b, what in ((g_mx, w_mx, "max"), (g_lse, w_lse, "lse")):
            check(torch.allclose(a, b, rtol=tol, atol=tol),
                  f"{label} exit {e}: exit head {what} differs by "
                  f"{float((a - b).abs().max())}")
        # the card's token is the CPU's, or a near-tie in the CPU's logits
        last = want[:, -1]
        picked = last.gather(1, g_idx.long()[:, None])[:, 0]
        check(bool(torch.all((g_idx == w_idx) | (
            (last.amax(-1) - picked) <= tol))),
              f"{label} exit {e}: exit head token {g_idx.tolist()} vs "
              f"{w_idx.tolist()}")
        errs[f"{label}/exit{e}"] = max(
            err, float((g_mx - w_mx).abs().max()),
            float((g_lse - w_lse).abs().max()))
    return errs


def phase_lm_models(configs, device, seq=LM_PROMPT):
    """SmolLM (the first config) at full depth, every exit; the others cut
    to 2 layers and one exit; all in float32, card against CPU."""
    import dataclasses

    import torch

    from repro_torch.models import DecoderLM

    errs, cuts = {}, {}
    for i, (arch, cfg) in enumerate(configs.items()):
        if i == 0:
            cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
            batch_size, s, exits = 2, seq, range(cfg.num_exits)
        else:
            cfg32 = dataclasses.replace(cfg, num_layers=2, exits=(2,),
                                        dtype=torch.float32)
            batch_size, s, exits = 1, 32, (0,)
            cuts[arch] = "2 layers, one exit, B=1, S=32"
        gen = torch.Generator(device=device).manual_seed(7 + i)
        model = DecoderLM(cfg32, generator=gen, device=device).eval()
        errs.update(_lm_check_pair(model, batch_size, s, exits, arch))
        del model
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    emit("lm_models", max_abs_err_vs_cpu=errs, tol=LM_TOL["float32"],
         cut=cuts)
    return errs


# ---------------------------------------------------------------------------
# Phase 7: KV-cache decode of the LMs on the card against the CPU, float32
# ---------------------------------------------------------------------------


def _decode_cache(model, prefill_cache, batch_size, max_len, exit_idx):
    """``init_cache`` buffers holding a prefill's caches."""
    cache = model.init_cache(batch_size, max_len, exit_idx)
    for buf, seg in zip(cache["segments"], prefill_cache["segments"]):
        n = seg["k"].shape[2]
        buf["k"][:, :, :n] = seg["k"]
        buf["v"][:, :, :n] = seg["v"]
        buf["len"][:] = seg["len"]
    return cache


def _teacher_forced(model, tokens, prompt, max_len, exit_idx):
    """Prefill ``tokens[:, :prompt]``, then decode the rest one token at a
    time. Returns (the prefill's and every step's logits ``[B, 1 + steps,
    V]``, the final cache), on the CPU."""
    import torch

    dev = model.embed.device
    tokens = tokens.to(dev)
    with torch.inference_mode():
        logits, pref = model.prefill({"tokens": tokens[:, :prompt]},
                                     exit_idx)
        cache = _decode_cache(model, pref, tokens.shape[0], max_len,
                              exit_idx)
        outs = [logits]
        for i in range(prompt, tokens.shape[1]):
            logits, cache = model.decode_step(tokens[:, i:i + 1], cache,
                                              exit_idx)
            outs.append(logits)
    cpu = {"segments": [{key: t.cpu() for key, t in seg.items()}
                        for seg in cache["segments"]]}
    return torch.cat(outs, dim=1).cpu(), cpu


def phase_lm_decode_models(configs, device, prompt=DECODE_CHECK["prompt"],
                           steps=DECODE_CHECK["steps"],
                           max_len=DECODE_CHECK["max_len"]):
    """The decode path in float32, card against CPU: SmolLM (the first
    config) at full width and depth, every exit; the others at full width
    cut to 2 layers and one exit. Each prefills a ``prompt``-token prompt,
    copies its caches into ``init_cache(2, max_len)`` buffers and decodes
    ``steps`` teacher-forced tokens. The card's logits and caches must
    equal the CPU's, and the card's logits ``forward_exit``'s over the whole
    sequence at the same positions (the reference's own check,
    ``tests/test_models.py:80``), within 2e-3."""
    import dataclasses

    import torch

    from repro_torch.models import DecoderLM

    t0 = time.perf_counter()
    tol = LM_TOL["float32"]
    errs, cuts = {}, {}
    for i, (arch, cfg) in enumerate(configs.items()):
        if i == 0:
            cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
            exits = range(cfg.num_exits)
        else:
            cfg32 = dataclasses.replace(cfg, num_layers=2, exits=(2,),
                                        dtype=torch.float32)
            exits = (0,)
            cuts[arch] = "2 layers, one exit"
        gen = torch.Generator(device=device).manual_seed(17 + i)
        model = DecoderLM(cfg32, generator=gen, device=device).eval()
        tokens = torch.randint(0, cfg.vocab_size, (2, prompt + steps),
                               generator=torch.Generator().manual_seed(i))
        card, full = {}, {}
        for e in exits:
            card[e] = _teacher_forced(model, tokens, prompt, max_len, e)
            with torch.inference_mode():
                full[e] = model.forward_exit(
                    {"tokens": tokens.to(device)}, e)[:, prompt - 1:].cpu()
        model = model.to("cpu")
        for e in exits:
            label = f"{arch}/exit{e}"
            got, got_cache = card[e]
            want, want_cache = _teacher_forced(model, tokens, prompt,
                                               max_len, e)
            check(got.shape == (2, steps + 1, cfg.vocab_padded)
                  and bool(torch.isfinite(got).all()),
                  f"{label}: decode logits {tuple(got.shape)} or not finite")
            e_cpu = float((got - want).abs().max())
            e_full = float((got - full[e]).abs().max())
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"{label}: card and CPU decode logits differ by {e_cpu}")
            check(torch.allclose(got, full[e], rtol=tol, atol=tol),
                  f"{label}: decode and forward_exit differ by {e_full}")
            e_cache = 0.0
            for g, w in zip(got_cache["segments"], want_cache["segments"]):
                check(torch.equal(g["len"], w["len"])
                      and int(g["len"].min()) == prompt + steps,
                      f"{label}: cache lengths {g['len'].tolist()}")
                for key in ("k", "v"):
                    check(torch.allclose(g[key], w[key], rtol=tol, atol=tol),
                          f"{label}: card and CPU cache {key} differ")
                    e_cache = max(e_cache,
                                  float((g[key] - w[key]).abs().max()))
            errs[label] = dict(logits_vs_cpu=e_cpu, cache_vs_cpu=e_cache,
                               logits_vs_forward_exit=e_full)
        del model, card, full
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    emit("lm_decode_models", max_abs_err=errs, tol=tol, batch=2,
         prompt=prompt, steps=steps, max_len=max_len, cut=cuts,
         seconds=time.perf_counter() - t0)
    return errs


# ---------------------------------------------------------------------------
# Phase 8: live LM serving
# ---------------------------------------------------------------------------


def _expected_launches(served, decisions):
    """Launches of each LM kernel implied by the engine's decisions:
    rmsnorm 2 L_e per quantum (+ L_e for per-head q/k norm: q and k in one
    launch), flash attention L_e, the exit head 1."""
    want = {"rmsnorm": 0, "flash_attention": 0, "exit_head": 0}
    for d in decisions:
        cfg = served[d.model].values.cfg
        layers = cfg.exits[d.exit_idx]
        want["rmsnorm"] += layers * (3 if cfg.qk_norm else 2)
        want["flash_attention"] += layers
        want["exit_head"] += 1
    return want


def phase_lm_serving(configs, device, horizon=HORIZON_S):
    import torch

    from repro_torch.core import (
        SchedulerConfig,
        make_scheduler,
        poisson_arrivals,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime.server import (
        ServingEngine,
        measure_profile,
        run_quantum,
        serve_lms,
    )

    t0 = time.perf_counter()
    served = serve_lms(configs, device=device, seed=0,
                       prompt_len=LM_PROMPT, max_batch=LM_BATCHES[-1])
    build_s = time.perf_counter() - t0
    params = {m.name: sum(p.numel() for p in m.values.parameters())
              for m in served}
    # one untimed pass over every cell first (clocks, cuBLAS heuristics)
    for mod in served:
        for e in range(mod.num_exits):
            for b in LM_BATCHES:
                run_quantum(mod, e, b)
    clocks_before = smi("clocks.sm,power.draw")
    t0 = time.perf_counter()
    table = measure_profile(served, batch_sizes=LM_BATCHES,
                            exit_names=("exit0", "exit1", "exit2", "exit3"),
                            repeats=10, warmup=2)
    profile_s = time.perf_counter() - t0
    clocks_after = smi("clocks.sm,power.draw")
    check(table.latency.shape == (3, 4, len(LM_BATCHES)), "LM profile shape")
    lat_ms = table.latency * 1e3
    emit("lm_profile", seconds=profile_s, build_seconds=build_s,
         params=params, platform=table.meta["platform"],
         sm_clock_power=[clocks_before, clocks_after],
         cells=int(table.latency.size),
         ms={f"{table.model_names[m]}/{table.exit_names[e]}":
             [float(x) for x in lat_ms[m, e]]
             for m in range(3) for e in range(4)},
         batch_sizes=list(LM_BATCHES),
         peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if torch.device(device).type == "cuda" else None))

    # total rate: sum_m lambda_m L(m, final, B_max) / B_max = LM_BUSY
    split = np.array([3.0, 2.0, 1.0]) / 6.0
    per_request = table.latency[:, -1, -1] / LM_BATCHES[-1]
    total = LM_BUSY / float(np.sum(split * per_request))
    rates = total * split
    emit("lm_rate", total_req_s=total, per_model_req_s=rates.tolist(),
         busy_target=LM_BUSY,
         final_b8_ms=(table.latency[:, -1, -1] * 1e3).tolist())

    cfg = SchedulerConfig(slo=SLO, max_batch=LM_BATCHES[-1], backend="cuda",
                          device=device)
    sched = RecordingScheduler(make_scheduler("edgeserving", table, cfg))
    engine = ServingEngine(served, sched)
    engine.warmup()
    arrivals = poisson_arrivals(rates.tolist(), horizon, seed=0)
    reset_launch_counts()
    completions, span = engine.run(arrivals, horizon, drain=True)
    launches = {k: launch_counts[k] for k in KERNELS}
    m = engine.metrics(table, SLO, span)
    decisions = [d for _, d in sched.rounds if d is not None]
    scored = [(s, d) for s, d in sched.rounds if s.nonempty()]
    want = _expected_launches(served, decisions)
    residual = m.residual_queue
    emit("lm_serve", arrivals=len(arrivals), completed=len(completions),
         dropped=engine.dropped, residual=residual, span_s=span,
         p95_ms=m.p95_latency * 1e3, p50_ms=m.p50_latency * 1e3,
         violation_ratio=m.violation_ratio,
         mean_exit_depth=m.mean_exit_depth, utilization=m.utilization,
         throughput=m.throughput, mean_batch=m.mean_batch,
         quanta=len(decisions), scoring_rounds=len(scored),
         launches=launches, launches_implied=want,
         per_model=[dict(model=pm.model, completed=pm.num_completed,
                         violation_ratio=pm.violation_ratio,
                         p95_ms=pm.p95_latency * 1e3,
                         mean_exit_depth=pm.mean_exit_depth)
                    for pm in m.per_model])
    check(len(completions) + engine.dropped + residual == len(arrivals),
          "LM arrivals not conserved")
    check(len(decisions) > 0, "no LM quantum ran")
    check(launches["stability_score"] == len(scored),
          f"stability launches {launches['stability_score']} != scoring "
          f"rounds {len(scored)}")
    for kernel, n in want.items():
        check(launches[kernel] == n,
              f"{kernel} launches {launches[kernel]} != {n} implied by the "
              f"decisions")
    shadow_check("lm_shadow", scored, table, max_batch=LM_BATCHES[-1])
    lm_breakdown(served)
    return launches, served


def _kernel_class(name: str) -> str:
    low = name.lower()
    for key in ("rmsnorm", "flash_attention", "exit_head", "decode_attention"):
        if key in low:
            return key
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "matmul"
    return "other"


def _device_ms_by_class(prof):
    """Device time (ms) and kernel count by class from a profiler run."""
    import torch

    by_class, counts = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = _kernel_class(evt.name)
        by_class[cls] = by_class.get(cls, 0.0) + evt.device_time_total / 1e3
        counts[cls] = counts.get(cls, 0) + 1
    return by_class, counts


def lm_breakdown(served):
    """Where a quantum's time goes, at the final exit and B = 1 and 8: the
    host-clock time of a quantum (median of 5, no profiler), and from one
    quantum under ``torch.profiler`` the device time of its kernels by class
    (our three kernels, matrix products, the rest); idle share = 1 - device
    time / quantum time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.server import run_quantum

    rows = {}
    for mod in served:
        e = mod.num_exits - 1
        for b in (1, LM_BATCHES[-1]):
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                run_quantum(mod, e, b)
                walls.append(time.perf_counter() - t0)
            wall_ms = float(np.median(walls)) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_quantum(mod, e, b)
            by_class, counts = _device_ms_by_class(prof)
            device_ms = sum(by_class.values())
            rows[f"{mod.name}/final/B{b}"] = dict(
                quantum_ms=wall_ms, device_ms=device_ms,
                idle_share=1.0 - device_ms / wall_ms,
                device_ms_by_class=by_class, kernels_by_class=counts)
    emit("lm_breakdown", rows=rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 9: KV-cache decode of the served LMs, bfloat16, full size
# ---------------------------------------------------------------------------


def _decode_launches_implied(cfg, exit_idx, steps):
    """Launches a run of decode steps implies: decode attention L_e a
    step; rmsnorm 2 L_e (+L_e with q/k norm: q and k in one launch) + 1
    (the exit norm)."""
    layers = cfg.exits[exit_idx]
    return {"decode_attention": steps * layers,
            "rmsnorm": steps * (layers * (3 if cfg.qk_norm else 2) + 1)}


def _check_profiled_steps(label, seen, layers):
    """``seen``: the kernels by class of each profiled decode step, the last
    one kept. One decode-attention kernel a call: the kept trace holds L_e
    of them and no trace more. An earlier, short trace was retaken; it is a
    lost profiler event, and not a kernel counted but never launched, only
    where another class lost kernels against the kept trace too."""
    kept = seen[-1]
    counts = [c.get("decode_attention", 0) for c in seen]
    check(counts[-1] == layers and max(counts) == layers,
          f"{label}: {counts} decode-attention kernels in the profiled "
          f"steps, not {layers}")
    for short in seen[:-1]:
        check(any(short.get(k, 0) < n for k, n in kept.items()
                  if k != "decode_attention"),
              f"{label}: a profiled step lost only decode-attention "
              f"kernels: {short} against {kept}")


def phase_lm_decode(served, device, steps=DECODE_STEPS,
                    max_len=DECODE_MAX_LEN):
    """The decode path of the served models at full width and depth in
    bfloat16: for B in {1, 8} at the first and the final exit, prefill the
    served 128-token prompt, copy the caches into ``init_cache(B,
    max_len)`` and decode ``steps`` greedy tokens. Per run: the median host
    time of a step (clock around the step and a synchronise, without the
    profiler), one step under ``torch.profiler`` for the device time of its
    kernels by class and the idle share (1 - device / host), the peak
    memory, and the launches of the steps, which must equal the count the
    steps imply; the profiled step must hold one decode-attention kernel a
    layer (one kernel a call). Logits must be finite and tokens in the
    vocabulary; the last step's logits against ``forward_exit`` over the
    whole sequence are reported, not held (the float32 phase holds the
    numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import synchronize
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rows, launches, implied = {}, {}, {}
    for mod in served:
        model, cfg = mod.values, mod.values.cfg
        for b in (1, LM_BATCHES[-1]):
            prompt = mod.data_fn(b)
            for e in (0, cfg.num_exits - 1):
                layers = cfg.exits[e]
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                with torch.inference_mode():
                    logits, pref = model.prefill({"tokens": prompt}, e)
                    cache = _decode_cache(model, pref, b, max_len, e)
                    del pref
                    tok = logits.argmax(-1)
                    generated, finite, walls = [tok], [], []
                    synchronize(dev)
                    reset_launch_counts()
                    traces = []  # (device ms, kernels) by class
                    for i in range(steps):
                        if (steps // 2 <= i < steps // 2 + PROFILE_TRIES
                                and (not traces or traces[-1][1].get(
                                    "decode_attention", 0) < layers)):
                            with profile(activities=[
                                    ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
                                logits, cache = model.decode_step(tok, cache,
                                                                  e)
                                synchronize(dev)
                            traces.append(_device_ms_by_class(prof))
                        else:
                            t0 = time.perf_counter()
                            logits, cache = model.decode_step(tok, cache, e)
                            synchronize(dev)
                            walls.append(time.perf_counter() - t0)
                        finite.append(torch.isfinite(logits).all())
                        tok = logits.argmax(-1)
                        generated.append(tok)
                    counts = {k: launch_counts[k] for k in
                              ("decode_attention", "rmsnorm")}
                    seq = torch.cat([prompt] + generated[:-1], dim=1)
                    full = model.forward_exit({"tokens": seq}, e)[:, -1]
                    last = logits[:, 0]
                    vs_full = dict(
                        max_abs=float((last - full).abs().max()),
                        top1_agree=float((last.argmax(-1) == full.argmax(-1))
                                         .float().mean()))
                gen_tokens = torch.cat(generated, dim=1)
                label = f"{mod.name}/exit{e}/B{b}"
                want = _decode_launches_implied(cfg, e, steps)
                for k, n in counts.items():
                    launches[k] = launches.get(k, 0) + n
                    implied[k] = implied.get(k, 0) + want[k]
                by_class, kcounts = traces[-1]
                if on_card:
                    _check_profiled_steps(label, [t[1] for t in traces],
                                          layers)
                host_ms = float(np.median(walls)) * 1e3
                device_ms = sum(by_class.values())
                rows[label] = dict(
                    layers=layers, step_host_ms=host_ms,
                    profiled_kernels=[t[1] for t in traces],
                    step_device_ms=device_ms,
                    idle_share=1.0 - device_ms / host_ms,
                    device_ms_by_class=by_class, kernels_by_class=kcounts,
                    peak_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                                    if on_card else None),
                    launches=counts, launches_implied=want,
                    last_step_vs_forward_exit=vs_full)
                check(bool(torch.stack(finite).all()),
                      f"{label}: decode logits not finite")
                check(bool(((gen_tokens >= 0)
                            & (gen_tokens < cfg.vocab_size)).all()),
                      f"{label}: a token outside the vocabulary")
                del cache, logits, full
    emit("lm_decode", steps=steps, prompt=LM_PROMPT, max_len=max_len,
         rows=rows, launches=launches, launches_implied=implied,
         seconds=time.perf_counter() - t_phase)
    for label, row in rows.items():
        for k, n in row["launches_implied"].items():
            check(row["launches"][k] == n, f"{label}: {k} launches "
                  f"{row['launches'][k]} != {n} implied by the steps")
    return launches


# ---------------------------------------------------------------------------
# The kernel summary line
# ---------------------------------------------------------------------------

LM_KERNEL_ROWS = {
    # kernel: (source, the TPU kernel it replaces, the main timed case)
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:18",
                f"{LM_ARCHS[-1]}/residual"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:27",
                        f"{LM_ARCHS[-1]}/prefill"),
    "exit_head": ("src/repro_torch/csrc/exit_head.cu",
                  "src/repro/kernels/exit_head/kernel.py:28",
                  f"{LM_ARCHS[-1]}/served"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:26",
                         f"{LM_ARCHS[-1]}/served"),
}


def kernel_summary(kernel, resnet_launches, lm_kernels, lm_launches,
                   decode_launches):
    """One entry per kernel of the port's paths, with every key of the
    contract; the stability score's launches are both serving runs', and
    rmsnorm's those of the LM serve and the decode phase."""
    t3 = kernel["timings"]["m3"]
    t256 = kernel["timings"]["m256"]
    rows = [{
        "name": "stability_score",
        "route": "cuda",
        "source": "src/repro_torch/csrc/stability_score.cu",
        "replaces": "src/repro/kernels/stability_score/kernel.py:35",
        "launches": resnet_launches + lm_launches["stability_score"],
        "launches_resnet_serve": resnet_launches,
        "launches_lm_serve": lm_launches["stability_score"],
        "max_abs_err": kernel["max_abs_err"],
        "max_rel_err": kernel["max_rel_err"],
        "ms": t3["ms"],
        "kernel_ms": t3["kernel_ms"],
        "eager_ms": t3["eager_ms"],
        "plain_ms": t3["plain_ms"],
        "bound_ms": t3["bound_ms"],
        "bound_by": t3["bound_by"],
        "library_ms": None,
        "ms_m256": t256["ms"],
        "kernel_ms_m256": t256["kernel_ms"],
        "eager_ms_m256": t256["eager_ms"],
        "plain_ms_m256": t256["plain_ms"],
        "bound_ms_m256": t256["bound_ms"],
        "bound_by_m256": t256["bound_by"],
    }]
    for name, (source, replaces, main_case) in LM_KERNEL_ROWS.items():
        timings = lm_kernels["timings"][name]
        t = timings[main_case]
        paths = {"lm_serve": lm_launches.get(name, 0),
                 "lm_decode": decode_launches.get(name, 0)}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            **{f"launches_{p}": n for p, n in paths.items()},
            "max_abs_err": lm_kernels["errs"][name]["float32"],
            "max_abs_err_bf16": lm_kernels["errs"][name]["bfloat16"],
            "case": main_case, "shape": t["shape"], "dtype": t["dtype"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{k: t[k] for k in ("path", "cold_ms") if k in t},
            "cases": timings,
        })
        f32 = timings.get(f"{main_case}/float32")
        if f32 is not None:
            rows[-1].update({f"{k}_f32": f32[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return rows


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
    from repro_torch.configs import FULL, get_config

    lm_configs = {arch: get_config(arch) for arch in LM_ARCHS}
    phase_device_and_build()
    kernel = phase_kernel("cuda")
    lm_kernels = phase_lm_kernels(lm_configs, "cuda")
    served = phase_models(FULL, "cuda")
    resnet_launches = phase_serving(served, "cuda")
    del served
    torch.cuda.empty_cache()
    phase_lm_models(lm_configs, "cuda")
    phase_lm_decode_models(lm_configs, "cuda")
    lm_launches, served = phase_lm_serving(lm_configs, "cuda")
    decode_launches = phase_lm_decode(served, "cuda")
    del served
    print(json.dumps({"kernels": kernel_summary(
        kernel, resnet_launches, lm_kernels, lm_launches,
        decode_launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
