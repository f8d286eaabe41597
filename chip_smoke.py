#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It drives the port's live paths end to end, the paper's ResNets and the
early-exit LMs (served quanta and KV-cache decode):

1. device and build: the card's name and power limit, the seven CUDA
   kernels (the five forward kernels and the two backward kernels of the
   training path) built from ``src/repro_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` in one parallel round (with each one's ptxas report), TF32
   off;
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
6. the serving simulator through ``SweepRunner.run_cell`` and
   ``ServingSimulator``: the fig4 lambda=140 golden cell, the fig12 lattice
   cell at 30 ms and lambda=240, and fig15's thermal-throttle cell under
   online adaptation, each with the ``numpy`` and the ``cuda`` scoring
   backend; the numpy runs hold ``tests/data/golden_metrics.json`` at
   rtol 1e-9, the ``cuda`` runs decide as the numpy shadow does on the same
   snapshots and tables (float32 ties aside), and the stability kernel
   launches once per scoring round; each backend's host time per round and
   wall time per cell;
7. fleets (``fleet``): the four fig14 cells (the heterogeneous fleet of 4
   under stability-aware, round-robin and JSQ dispatch, and one device under
   least-loaded) through ``SweepRunner.run_cell`` and the cell's
   ``ClusterSimulator`` with every device's rounds recorded, with the
   ``numpy`` and the ``cuda`` backend: the numpy runs hold the fig14
   goldens at rtol 1e-9 and their quoted strings, the ``cuda`` runs decide
   as the numpy shadow does and (with no float32 tie) give its metrics,
   stability launches = the devices' scoring rounds, and every arrival is
   completed, dropped or residual; then the het stability-aware cell with
   device 1 failing at 2 s, traced under ``cuda``: fail-over events, one
   span per arrival, numpy's metrics, and launches = scoring rounds + the
   traced rounds ``decision_margin`` scores again; per-device round means
   and wall times;
   then the compiled scan tiers (``scan``: ``core/simfast.py``,
   ``clusterfast.py``, ``seedband.py``; lanes of one float64 step, each
   chunk of steps a replayed CUDA graph; no repo kernel): the fig4 golden
   cell through ``SweepSpec(engine="scan")`` (goldens at rtol 1e-9, and
   the Python engine's metrics bitwise), fig17's smoke cells on the card
   against the same calls on the CPU (in two spawned workers meanwhile),
   the first chunk of two step objects built from one plan (golden and
   fleet shapes) replayed against the same blocks run eagerly (bitwise),
   fig17's grid cell at 1000 seeds and its het fleet cell at 64 seeds per
   dispatcher, timed alone on the host (wall time per seed and its host
   split beside the Python engine's, 2 lanes each decided as the Python
   engine does, with their exact and float64 near-ties, and the fleet's
   ``compare_bands`` gap);
8. the LMs on the card against the CPU in float32: SmolLM-135M at full
   width and depth at every exit, Phi-4-mini and Qwen3-8B at full width cut
   to 2 layers and one exit;
9. KV-cache decode on the card against the CPU in float32, the same models
   and cuts: prefill, then 16 teacher-forced decode steps; logits and
   caches against the CPU's, logits against ``forward_exit``;
10. live LM serving: SmolLM-135M, Phi-4-mini and Qwen3-8B at full width and
   depth in bfloat16, ``measure_profile`` over 3 x 4 x 4 cells, then a 3 s
   Poisson trace at 3:2:1 whose total rate keeps the card 90% busy at the
   final exit and B = 8, served with the ``cuda`` scoring backend and the
   float64 shadow; each LM kernel's launches must equal the count implied
   by the engine's decisions;
11. KV-cache decode of the same three models in bfloat16: B = 1 and 8 at the
   first and final exit, 32 greedy steps after the 128-token prompt; step
   time on the host, device time by kernel class, idle share, peak memory;
   decode-attention and rmsnorm launches must equal the count the steps
   imply, and the profiled step must run one decode-attention kernel a
   layer; then (PR 26) the cost phase (``cost``): the NCCL host mesh and
   ``ElasticMesh.build`` on the card, ``compressed_psum`` on a card tensor
   (bitwise its one-rank value and the CPU's), the roofline L(m, e, B)
   table of phase 10's 48 cells counted shape-only on the one-device mesh
   (``launch/roofline.py::roofline_profile``; no measured P95 may be below
   its ``t_star``), the ``cuda`` simulator on the roofline table, the
   measured table and roofline plans against measured service (stability
   launches = scoring rounds), ``qwen3-8b`` ``train_4k`` lowered on the
   (16, 16) production mesh (``launch/dryrun.py::lower_cell``), its flops
   a device held to the reference's count (``COST_REFERENCE_FLOPS``), and
   the six families' two-layer train cells counted on this torch beside
   the CPU's counts (``COST_TRAIN_CPU``), and the decode attention's two
   serve cells (Jamba ``long_500k``, Seamless ``decode_32k`` on (2, 16,
   16)) the same, their collective bytes within 4x of the reference's;
12. the rest of the model zoo (``lm_zoo``): the LM kernels against their
   plain versions at the zoo's new shapes (GQA groups 9 and 1, head dim
   64, the Seamless encoder's non-causal S = 1024, LLaVA's 2880 patches,
   rmsnorm rows of 7168/1536/512/64, exit heads at D = 7168 and V =
   256206), timed; (a) DeepSeek-MoE-16B, DeepSeek-V3, Jamba, RWKV6,
   SeamlessM4T, StarCoder2 and LLaVA-NeXT on the card against the CPU in
   float32 at full width (depth and routed experts cut, printed in
   ``cut``): every exit's logits and exit decision, the MoE and Jamba
   models block by block on the CPU's inputs (expert sets compared token
   by token, every flip a near-tie, outputs of the tokens routed alike
   held), a teacher-forced decode against the prefill (MLA in both forms,
   Seamless also from ``prepare_decode_cache``); (b) the seven in bfloat16
   at full width one at a time (Jamba 16 layers, V3 5), every exit at
   B = 1 and 8 with the launches the family implies, the host/device split
   of a final-exit quantum, the router's ties, then 16 greedy decode steps
   at B = 1; (c) RWKV6, Seamless, StarCoder2 and DeepSeek-MoE served live
   together (profile, then Poisson 4:3:2:1 at 90% busy, SLO 50 ms, the
   ``cuda`` backend beside the numpy shadow, launches as implied);
13. the ``serve_multi_model`` LMs (``lm_multi``): the three float32 LMs of
   ``examples/serve_multi_model.py`` (head dims 16 and 32) built by
   ``examples_torch/serve_multi_model.py``, card against CPU at every exit,
   their kernels against the plain versions at their shapes (flash
   attention at D = 16 and 32), ``measure_profile`` over B in {1, 2, 4, 8},
   then 3 s of Poisson 3:2:1 traffic at 150 req/s served with the ``cuda``
   backend, an ``OnlineProfiler`` and a ``Tracer`` beside the numpy shadow:
   launches as the quanta imply (stability: scoring rounds + re-scored
   traced rounds), refresh events = ``profiler_refreshes``, one span per
   arrival, ``tools/tracestats.py`` reading both exports, and one profiled
   quantum per model (idle share);
14. training (``train``): the backward kernels (``rmsnorm_bwd`` with the
   q/k pair, ``flash_attention_bwd``) against their plain versions at the
   trained shapes of the three LMs (B = 8, S = 256; attention also at
   B = 1, S = 2048, ragged S = 77 and non-causal) in bfloat16 and float32,
   each run twice and held bitwise, timed beside the bound, the plain
   backward and autograd of ``F.rms_norm`` / SDPA; one float32 train step
   on the card against the CPU (loss, every parameter's gradient by name,
   the AdamW-updated values) for SmolLM-135M at full width and depth,
   Phi-4-mini and Qwen3-8B at full width cut to 2 layers and one exit, and
   ResNet-50 FULL; then SmolLM-135M FULL in bfloat16 with float32 masters
   through ``launch/train.py``'s loop (B = 8, S = 256, 30 steps, a
   checkpoint every 10): uninterrupted, preempted after step 19, and
   resumed with a fresh model, optimizer and stream; the loss falls, the
   resumed values are within 1e-6 of the uninterrupted run's, every step
   launches what ``train_implied_launches`` gives, with a step's host and
   device time (one step profiled), tokens/s and peak memory;
15. the kernel summary line (the backward kernels beside the five), then
   ``{"ok": true, ...}`` as the last line.

Each phase prints JSON lines. Any failed check raises, so the script exits
non-zero before the last line. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import multiprocessing
import subprocess
import sys
import tempfile
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
# the backward kernels of the training path (no TPU kernel: the reference
# takes these gradients with XLA's autodiff)
BWD_KERNELS = ("rmsnorm_bwd", "flash_attention_bwd")
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


def graph_ms(fn, iters: int, per_graph: int = 20, stream=None) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph and replayed ``iters`` times, so the host's launch cost is
    not in the number. ``stream``: the side stream to warm up and capture
    on (an autograd backward runs on its forward's stream, so a backward is
    captured on the stream its forward ran on)."""
    import torch

    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    paths = build.build(list(KERNELS + BWD_KERNELS))
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.BUILD_LOG.get(
        name, {}).get("ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln or "entry function" in ln]
        for name in KERNELS + BWD_KERNELS}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("build", card=card, torch=torch.__version__,
         cuda=torch.version.cuda,
         libraries={n: p.name for n, p in paths.items()},
         build_seconds=seconds,
         per_kernel_seconds={n: build.BUILD_LOG.get(n, {}).get("seconds")
                             for n in KERNELS + BWD_KERNELS},
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


def record_rounds(sched):
    """Wrap ``sched.decide`` on the instance so that every round is kept as
    (snapshot, decision, the table decided with, host seconds). The engine
    and the simulator call the scheduler itself, so a table that the
    simulator's online profiler swaps in is the one recorded."""
    rounds, decide = [], sched.decide

    def recording(snapshot):
        t0 = time.perf_counter()
        d = decide(snapshot)
        rounds.append((snapshot, d, sched.table, time.perf_counter() - t0))
        return d

    sched.decide = recording
    return rounds


def _score_of(sched, snapshot, pick):
    """float64 score of the candidate ``pick`` = (model, exit, batch)."""
    cq, cb, ce, cl, _ = sched.enumerate_candidates(snapshot)
    scores = sched.score_candidates(snapshot, cl, cb, cq)
    (i,) = [i for i in range(len(cq)) if (cq[i], ce[i], cb[i]) == pick]
    return float(scores[i])


def shadow_check(phase, scored, max_batch, policy="edgeserving", slo=SLO):
    """Decide every recorded scoring round again with the float64 numpy
    scheduler of ``policy``, on the same snapshot and table; a decision
    that differs must be a float32 tie. Returns the numpy scheduler and
    the number of ties."""
    from repro_torch.core import SchedulerConfig, make_scheduler

    shadow = make_scheduler(policy, scored[0][2],
                            SchedulerConfig(slo=slo, max_batch=max_batch))
    mismatches = ties = 0
    for snap, d, table, _ in scored:
        shadow.table = table
        ds = shadow.decide(snap)
        pick, pick_host = ((d.model, d.exit_idx, d.batch_size),
                           (ds.model, ds.exit_idx, ds.batch_size))
        if pick == pick_host:
            continue
        s_card = _score_of(shadow, snap, pick)
        s_host = _score_of(shadow, snap, pick_host)
        if abs(s_card - s_host) <= TIE_RTOL * abs(s_host):
            ties += 1
        else:
            mismatches += 1
    emit(phase, rounds=len(scored), mismatches=mismatches,
         float32_ties=ties, tables=len({id(r[2]) for r in scored}))
    check(mismatches == 0, f"{mismatches} decisions differ from the numpy "
                           f"shadow beyond float32 ties")
    return shadow, ties


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
    sched = make_scheduler("edgeserving", table, cfg)
    rounds = record_rounds(sched)
    engine = ServingEngine(served, sched)
    engine.warmup()
    arrivals = poisson_arrivals(paper_rate_vector(LAMBDA_152), HORIZON_S,
                                seed=0)
    reset_launch_counts()
    completions, span = engine.run(arrivals, HORIZON_S, drain=True)
    launches = launch_counts["stability_score"]
    m = engine.metrics(table, SLO, span)
    scored = [r for r in rounds if r[0].nonempty()]
    residual = m.residual_queue
    emit("serve", arrivals=len(arrivals), completed=len(completions),
         dropped=engine.dropped, residual=residual, span_s=span,
         p95_ms=m.p95_latency * 1e3, p50_ms=m.p50_latency * 1e3,
         violation_ratio=m.violation_ratio,
         mean_exit_depth=m.mean_exit_depth, utilization=m.utilization,
         throughput=m.throughput, mean_batch=m.mean_batch,
         rounds=len(rounds), scoring_rounds=len(scored),
         kernel_launches=launches,
         mean_max_q=float(np.mean([max(r[0].qlens()) for r in scored])),
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

    shadow, _ = shadow_check("shadow", scored, max_batch=10)

    # per-round decision time on the recorded snapshots, host clock
    cuda_sched = make_scheduler("edgeserving", table, cfg)
    sample = [r[0] for r in scored][:500]
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
# Phase 6: the serving simulator and the sweep harness
# ---------------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "data" / "golden_metrics.json"
GOLDEN_RTOL = 1e-9  # tests/test_golden_metrics.py
FIG12_LAMBDAS = (20.0, 60.0, 100.0, 140.0, 180.0, 220.0, 240.0)
THROTTLE = (("onset", 1.5), ("ramp", 2.0), ("peak", 2.2))  # fig15


def sim_cells():
    """(name, execution table, SweepSpec fields) of each simulated cell:
    the fig4 golden, a fig12 lattice golden, and fig15's throttle row
    under online adaptation (``benchmarks/fig15_drift.py``; no golden)."""
    from repro_torch.core import AdaptConfig, ProfileTable

    paper = ProfileTable.paper_rtx3080()
    return (
        ("fig4_lam140", paper,
         dict(policy="edgeserving", rate=140.0, seed=7, horizon=10.0)),
        ("fig12_lattice_slo30_lam240", paper.with_batch_saturation(4),
         dict(policy="edgeserving-lattice", slo=0.030, rate=240.0, seed=7,
              horizon=10.0)),
        ("fig15_throttle_adaptive", paper,
         dict(policy="edgeserving", rate=140.0, seed=7, slo=0.050,
              horizon=8.0, drift="thermal-throttle", drift_kwargs=THROTTLE,
              adapt=AdaptConfig(refresh_every=0.25))),
    )


def golden_fields(name, metrics):
    """The cell's pinned golden values as (field, got, want) triples:
    the whole fig4 row, per model included, or the fig12 cell's
    ``per_lambda`` entry; none for a cell without a golden."""
    import dataclasses

    golden = json.loads(GOLDEN.read_text())
    if name == "fig4_lam140":
        got, want = dataclasses.asdict(metrics), golden["fig4_lam140"]
        check(got.keys() == want.keys(), "fig4 golden fields")
        out = []
        for key, value in want.items():
            if key in ("per_model", "per_device"):
                check(len(got[key]) == len(value), f"fig4 golden {key}")
                out += [(f"{key}[{i}].{f}", gm[f], wm[f])
                        for i, (gm, wm) in enumerate(zip(got[key], value))
                        for f in wm]
            else:
                out.append((key, got[key], value))
        return out
    if name == "fig12_lattice_slo30_lam240":
        entry = golden["fig12"]["edgeserving-lattice/slo30ms"]
        return [("violation_ratio", metrics.violation_ratio,
                 entry["per_lambda"][FIG12_LAMBDAS.index(240.0)])]
    return []


def _round_us(rounds):
    per = np.array([r[3] for r in rounds]) * 1e6
    return dict(mean=float(per.mean()), p50=float(np.median(per)),
                p95=float(np.percentile(per, 95)))


def phase_sim(device):
    """Each simulated cell through ``SweepRunner.run_cell``, with the
    ``numpy`` and the ``cuda`` scoring backend, then again through the
    cell's ``ServingSimulator`` with its rounds recorded (host time each)
    and its traces kept. The numpy run must hold the goldens at rtol 1e-9;
    the ``cuda`` run must decide as the numpy shadow does on the same
    snapshots and tables (float32 ties aside) and, with no tie, equal the
    numpy run; the stability kernel must launch once per scoring round.
    Returns the kernel's launches in the ``run_cell`` runs."""
    import torch

    from repro_torch.core import SweepRunner, SweepSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts

    on_card = torch.device(device).type == "cuda"
    total_launches = 0
    for name, table, fields in sim_cells():
        runner = SweepRunner(table)
        runs = {}
        for backend in ("numpy", "cuda"):
            spec = SweepSpec(**fields, backend=backend, device=device)
            reset_launch_counts()
            cell = runner.run_cell(spec)
            launches = launch_counts["stability_score"]
            sim = runner.simulator(spec)
            rounds = record_rounds(sim.scheduler)
            arrivals = runner.arrivals(spec)
            reset_launch_counts()
            t0 = time.perf_counter()
            res = sim.run(arrivals, spec.horizon,
                          warmup_tasks=spec.warmup_tasks, keep_traces=True)
            recorded_s = time.perf_counter() - t0
            recorded_launches = launch_counts["stability_score"]
            scored = [r for r in rounds if r[0].nonempty()]
            check(res.metrics == cell.metrics,
                  f"{name}/{backend}: the recorded run differs from "
                  f"run_cell")
            want = len(scored) if on_card and backend == "cuda" else 0
            check(launches == want and recorded_launches == want,
                  f"{name}/{backend}: stability launches {launches} and "
                  f"{recorded_launches}, want {want} (scoring rounds "
                  f"{len(scored)})")
            runs[backend] = dict(cell=cell, res=res, rounds=rounds,
                                 scored=scored, launches=launches,
                                 recorded_s=recorded_s)
        total_launches += runs["cuda"]["launches"]

        f64, f32 = runs["numpy"], runs["cuda"]
        held = golden_fields(name, f64["cell"].metrics)
        for field, got, want in held:
            check(bool(np.isclose(got, want, rtol=GOLDEN_RTOL, atol=0.0)),
                  f"{name}: golden {field} {got!r} != {want!r}")
        refreshes = len({id(r[2]) for r in f64["rounds"]}) - 1
        if fields.get("adapt") is not None:
            check(refreshes >= 1, f"{name}: the profiler never refreshed")
            check(f64["res"].adapted_table is not None,
                  f"{name}: no adapted table")
        _, ties = shadow_check(f"sim_shadow/{name}", f32["scored"],
                               max_batch=10, policy=fields["policy"],
                               slo=fields.get("slo", SLO))
        if ties == 0:
            check([(t.t_start, t.decision.model, t.decision.exit_idx,
                    t.decision.batch_size) for t in f32["res"].traces]
                  == [(t.t_start, t.decision.model, t.decision.exit_idx,
                       t.decision.batch_size) for t in f64["res"].traces],
                  f"{name}: cuda decisions differ from numpy with no tie")
            check(f32["cell"].metrics == f64["cell"].metrics,
                  f"{name}: cuda metrics differ from numpy with no tie")
        m64, m32 = f64["cell"].metrics, f32["cell"].metrics
        emit("sim", cell=name, title=f32["cell"].spec.title(),
             arrivals=len(arrivals),
             rounds=len(f32["rounds"]), scoring_rounds=len(f32["scored"]),
             kernel_launches=f32["launches"],
             round_us={b: _round_us(runs[b]["scored"]) for b in runs},
             wall_s={b: runs[b]["cell"].us_per_call / 1e6 for b in runs},
             # the recorded run's share spent deciding (its rounds' sum)
             decide_share={b: sum(r[3] for r in runs[b]["rounds"])
                           / runs[b]["recorded_s"] for b in runs},
             float32_ties=ties,
             golden_fields_held=len(held), refreshed_tables=refreshes,
             violation_ratio={"numpy": m64.violation_ratio,
                              "cuda": m32.violation_ratio},
             p95_ms={"numpy": m64.p95_latency * 1e3,
                     "cuda": m32.p95_latency * 1e3},
             completed=m64.num_completed)
    return total_launches


# ---------------------------------------------------------------------------
# The cost phase: mesh, collectives, roofline table, production-mesh cell
# ---------------------------------------------------------------------------

COST_HORIZON_S = 3.0
COST_CELL = ("qwen3-8b", "train_4k")   # lowered on the (16, 16) mesh
# the reference's count of that cell, flops a device (its lower_cell, JAX
# 0.9.0); tests/test_torch_dryrun_reference_train.py holds this constant
# to the reference, and the cost phase the port's count on the card to it
COST_REFERENCE_FLOPS = 667283298975744.0
# the six families' train_4k cut to two layers on the (16, 16) mesh (the
# overrides of tests/test_torch_dryrun_reference_train.py), and the port's
# counts of them with torch 2.13 on the CPU: flops a device, collective
# bytes a device, static bytes a device
COST_TRAIN_CELLS = {
    "qwen3-8b": {"num_layers": 2, "exits": (1, 2)},
    "deepseek-moe-16b": {"num_layers": 2, "exits": (2,)},
    "deepseek-v3-671b": {"num_layers": 2, "exits": (2,), "dense_prefix": 1},
    "jamba-v0.1-52b": {"num_layers": 2, "exits": (2,), "attn_period": 2,
                       "attn_offset": 1},
    "rwkv6-1.6b": {"num_layers": 2, "exits": (1, 2)},
    "seamless-m4t-large-v2": {"num_layers": 2, "exits": (1, 2)},
}
COST_TRAIN_CPU = {
    "qwen3-8b": [64261300682752.0, 78886470804.0, 76980224.0],
    "deepseek-moe-16b": [23492397367296.0, 77686899124.0, 51686912.0],
    "deepseek-v3-671b": [239972707729408.0, 129018053620.0, 251763136.0],
    "jamba-v0.1-52b": [39566312472576.0, 130093178440.0, 59399296.0],
    "rwkv6-1.6b": [12128987643904.0, 82343633644.0, 45765632.0],
    "seamless-m4t-large-v2": [90282292936704.0, 225769926884.0,
                              463830784.0],
}
# the two serve cells of the decode attention's partition rule, cut to two
# layers (the overrides of tests/test_torch_dryrun_reference_zoo.py), by
# (arch, shape, mesh); the port's counts of them with torch 2.13 on the CPU
# (flops, collective bytes, static bytes a device); and the reference's
# collective bytes a device (its lower_cell, JAX 0.9.0), which the card's
# count must keep within COST_COLLECTIVE_BAND (torch 2.11's DTensor had
# gathered Seamless's decode caches: 5.81x)
COST_SERVE_CELLS = {
    ("jamba-v0.1-52b", "long_500k", "single"): {
        "num_layers": 2, "exits": (2,), "attn_period": 2, "attn_offset": 1},
    ("seamless-m4t-large-v2", "decode_32k", "multi"): {
        "num_layers": 2, "exits": (1, 2)},
}
COST_SERVE_CPU = {
    ("jamba-v0.1-52b", "long_500k", "single"): [
        711516160.0, 87948.0, 594205704.0],
    ("seamless-m4t-large-v2", "decode_32k", "multi"): [
        2199502848.0, 152576.0, 1215211568.0],
}
COST_SERVE_REFERENCE_COLLECTIVES = {
    ("jamba-v0.1-52b", "long_500k", "single"): 124368.0,
    ("seamless-m4t-large-v2", "decode_32k", "multi"): 296968.0,
}
COST_COLLECTIVE_BAND = (0.25, 4.0)


def _cost_mesh_checks(device, card):
    """(a) The host mesh and ``ElasticMesh.build`` on the card (NCCL, one
    rank), and ``compressed_psum`` on a card tensor: with one rank it is
    ``dequantize_int8(*quantize_int8(x))`` bitwise, and the CPU's result."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import (
        compressed_psum,
        dequantize_int8,
        quantize_int8,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.fault_tolerance import ElasticMesh

    mesh = make_host_mesh(device=device)
    elastic, accum = ElasticMesh(model_axis=1).build(device=device)
    check(tuple(elastic.shape) == (1, 1) and accum == 16,
          f"ElasticMesh(1).build(): {tuple(elastic.shape)}, accum {accum}")
    gen = torch.Generator().manual_seed(0)
    x_cpu = torch.randn((4096, 1024), generator=gen) * 3.0
    x = x_cpu.to(device)
    got = compressed_psum(x)
    want = dequantize_int8(*quantize_int8(x))
    cpu = dequantize_int8(*quantize_int8(x_cpu))
    check(torch.equal(got, want), "compressed_psum != its one-rank value")
    check(torch.equal(got.cpu(), cpu), "compressed_psum differs from the CPU")
    emit("cost_mesh", card=card, backend=dist.get_backend(),
         host_mesh=list(mesh.shape), host_mesh_device=mesh.device_type,
         elastic_mesh=list(elastic.shape), elastic_accum=accum,
         psum_shape=list(x.shape), psum_bitwise=True,
         psum_max_abs_err_vs_x=float((got - x).abs().max()))
    return mesh


def phase_cost(device, configs, measured, horizon=COST_HORIZON_S,
               cell=COST_CELL):
    """(a) mesh and collectives; (b) the roofline L(m, e, B) table of the
    LM cell's three models counted shape-only on a one-device mesh
    (``repro_torch.launch.roofline.roofline_profile``) held under the
    measured table: no cell may measure below its ``t_star``; (c) the
    simulator with the ``cuda`` backend on each table (and planning on the
    roofline table against the measured service times), stability launches
    = scoring rounds; (d) ``lower_cell`` of ``cell`` on the (16, 16)
    production mesh, held to the reference's count; (e) the six two-layer
    train cells (``COST_TRAIN_CELLS``) on this torch, printed beside the
    CPU's counts, their flops and static bytes held equal to them; (f)
    the decode attention's two serve cells (``COST_SERVE_CELLS``) the
    same, and their collective bytes within ``COST_COLLECTIVE_BAND`` of
    the reference's. Returns the stability kernel's launches of (c)."""
    import torch

    from repro_torch.core import (
        SchedulerConfig,
        ServingSimulator,
        make_scheduler,
        poisson_arrivals,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh, release_mesh
    from repro_torch.launch.roofline import roofline_profile

    on_card = torch.device(device).type == "cuda"
    card = smi("name,power.limit")
    t_phase = time.perf_counter()
    mesh = _cost_mesh_checks(device, card)

    # (b) the roofline table beside the measured one
    t0 = time.perf_counter()
    table, counts = roofline_profile(
        configs, measured.batch_sizes, LM_PROMPT,
        exit_names=measured.exit_names, mesh=mesh,
        accuracy=measured.accuracy)
    count_s = time.perf_counter() - t0
    check(table.model_names == measured.model_names,
          "roofline and measured tables name different models")
    rows, below = [], []
    for (m, e, b), c in sorted(counts.items()):
        p95 = float(measured.latency[m, e, measured.batch_sizes.index(b)])
        rows.append(dict(model=measured.model_names[m], exit=e, batch=b,
                         flops=c["flops"], bytes=c["bytes"],
                         t_star_ms=c["t_star"] * 1e3, p95_ms=p95 * 1e3,
                         ratio=p95 / c["t_star"],
                         bound=("compute" if c["compute_s"] >= c["memory_s"]
                                else "memory")))
        if p95 < c["t_star"]:
            below.append(rows[-1])
    emit("cost_roofline", card=card, count_seconds=count_s,
         peak_flops=9.89e14, hbm_bytes_per_s=3.35e12, cells=rows,
         min_ratio=min(r["ratio"] for r in rows),
         roofline_ms=(table.latency * 1e3).tolist())
    check(not below, f"{len(below)} cells measure below their roofline "
          f"t_star (a miscount): {below[:3]}")

    # (c) the scheduler on both tables, at the LM cell's 3:2:1 rates
    split = np.array([3.0, 2.0, 1.0]) / 6.0
    per_request = measured.latency[:, -1, -1] / LM_BATCHES[-1]
    rates = (LM_BUSY / float(np.sum(split * per_request)) * split).tolist()
    arrivals = poisson_arrivals(rates, horizon, seed=0)
    runs, launches_total = {}, 0
    for name, plan, truth in (("roofline", table, table),
                              ("measured", measured, measured),
                              ("roofline_on_measured", table, measured)):
        cfg = SchedulerConfig(slo=SLO, max_batch=LM_BATCHES[-1],
                              backend="cuda", device=device)
        sched = make_scheduler("edgeserving", plan, cfg)
        rounds = record_rounds(sched)
        sim = ServingSimulator(sched, truth)
        reset_launch_counts()
        res = sim.run(arrivals, horizon)
        launches = launch_counts["stability_score"]
        scored = len([r for r in rounds if r[0].nonempty()])
        check(launches == (scored if on_card else 0),
              f"cost/{name}: stability launches {launches} != scoring "
              f"rounds {scored}")
        launches_total += launches
        m = res.metrics
        runs[name] = dict(violation_ratio=m.violation_ratio,
                          p95_ms=m.p95_latency * 1e3,
                          mean_exit_depth=m.mean_exit_depth,
                          completed=m.num_completed, rounds=len(rounds),
                          scoring_rounds=scored, kernel_launches=launches)
    emit("cost_sched", card=card, rates=rates, horizon_s=horizon,
         arrivals=len(arrivals), slo_ms=SLO * 1e3, runs=runs)

    # (d) one production-mesh cell
    release_mesh()
    prod = make_production_mesh(multi_pod=False)
    rec = lower_cell(cell[0], cell[1], prod, False)
    release_mesh()
    emit("cost_dryrun", card=card, arch=rec["arch"], shape=rec["shape"],
         mesh=rec["mesh"], rules=rec["rules"],
         flops_per_device=rec["hlo_metrics"]["flops"],
         bytes_per_device=rec["hlo_metrics"]["bytes"],
         collective_bytes=rec["collectives"]["bytes"],
         static_gib_per_device=rec["bytes_per_device_static"] / 2**30,
         model_flops=rec["model_flops"],
         lower_s=rec["lower_s"], run_s=rec["compile_s"])
    # the reference's own count of the cell (COST_REFERENCE_FLOPS)
    flops = rec["hlo_metrics"]["flops"]
    emit("cost_dryrun_check", card=card, flops_per_device=flops,
         reference_flops_per_device=COST_REFERENCE_FLOPS,
         over_reference=flops / COST_REFERENCE_FLOPS,
         flops_over_model_flops=flops * rec["num_devices"]
         / rec["model_flops"], torch=torch.__version__)
    check(abs(flops / COST_REFERENCE_FLOPS - 1.0) <= 1e-9,
          f"the production cell counts {flops:.6e} flops a device, the "
          f"reference {COST_REFERENCE_FLOPS:.6e}")

    # (e) the six families' two-layer train cells on this torch, beside
    # the CPU's counts (torch 2.13) recorded in COST_TRAIN_CPU: the flops
    # and static bytes must not depend on the torch version (the counter's
    # rules keep DTensor's choices out of them); the collective bytes may
    cells = {}
    prod = make_production_mesh(multi_pod=False)
    try:
        for arch, overrides in COST_TRAIN_CELLS.items():
            rec = lower_cell(arch, "train_4k", prod, False,
                             overrides=overrides)
            cpu = COST_TRAIN_CPU[arch]
            cells[arch] = dict(
                flops=rec["hlo_metrics"]["flops"],
                collective_bytes=rec["collectives"]["bytes"]["total"],
                static_bytes=rec["bytes_per_device_static"],
                run_s=rec["compile_s"], cpu=cpu,
                flops_as_cpu=rec["hlo_metrics"]["flops"] == cpu[0],
                static_as_cpu=rec["bytes_per_device_static"] == cpu[2],
                collective_bytes_over_cpu=(
                    rec["collectives"]["bytes"]["total"] / cpu[1]))
    finally:
        release_mesh()
    emit("cost_train_cells", card=card, torch=torch.__version__,
         cells=cells)
    differ = [a for a, c in cells.items()
              if not (c["flops_as_cpu"] and c["static_as_cpu"])]
    check(not differ, f"train cells whose flops or static bytes differ "
          f"from the CPU's on torch {torch.__version__}: {differ}")

    # (f) the decode attention's two serve cells on this torch: flops and
    # static bytes as the CPU's, collective bytes within the band of the
    # reference's
    cells = {}
    for (arch, shape, name), overrides in COST_SERVE_CELLS.items():
        multi = name == "multi"
        prod = make_production_mesh(multi_pod=multi)
        try:
            rec = lower_cell(arch, shape, prod, multi, overrides=overrides)
        finally:
            release_mesh()
        cpu = COST_SERVE_CPU[(arch, shape, name)]
        coll = rec["collectives"]["bytes"]["total"]
        ref = COST_SERVE_REFERENCE_COLLECTIVES[(arch, shape, name)]
        cells[f"{arch}:{shape}:{name}"] = dict(
            flops=rec["hlo_metrics"]["flops"], collective_bytes=coll,
            static_bytes=rec["bytes_per_device_static"],
            run_s=rec["compile_s"], cpu=cpu,
            flops_as_cpu=rec["hlo_metrics"]["flops"] == cpu[0],
            static_as_cpu=rec["bytes_per_device_static"] == cpu[2],
            collective_bytes_over_cpu=coll / cpu[1],
            collective_bytes_over_reference=coll / ref)
    emit("cost_serve_cells", card=card, torch=torch.__version__,
         cells=cells)
    lo, hi = COST_COLLECTIVE_BAND
    differ = [c for c, r in cells.items()
              if not (r["flops_as_cpu"] and r["static_as_cpu"]
                      and lo <= r["collective_bytes_over_reference"] <= hi)]
    check(not differ, f"serve cells whose flops or static bytes differ "
          f"from the CPU's, or whose collective bytes leave "
          f"{COST_COLLECTIVE_BAND} of the reference's, on torch "
          f"{torch.__version__}: {differ}")
    emit("cost_phase", card=card, seconds=time.perf_counter() - t_phase)
    return launches_total


# ---------------------------------------------------------------------------
# Phase 7: fleets, the cluster tier and its telemetry
# ---------------------------------------------------------------------------

FIG14_CELLS = ("het/stability-aware", "het/round-robin", "het/jsq",
               "scaling/G1/least-loaded")
FAIL_AT = ((1, 2.0),)  # the fail-over cell: device 1 of the het fleet


def fig14_fields(cell):
    """The SweepSpec fields of a fig14 golden cell
    (``tests/test_golden_metrics.py``)."""
    leg, dispatcher = cell.split("/")[0], cell.rsplit("/", 1)[1]
    fleet, size, rate = (("heterogeneous", 4, 640.0) if leg == "het"
                         else ("homogeneous", 1, 140.0))
    return dict(policy="edgeserving", scenario="mmpp", rate=rate, seed=7,
                horizon=6.0, fleet=fleet, fleet_size=size,
                dispatcher=dispatcher)


def run_recorded_cluster(sim, arrivals, spec):
    """Run a ``ClusterSimulator`` with every device's scheduler recorded
    (``record_rounds``): the schedulers are made inside ``run``, so the
    cluster module's ``make_scheduler`` is wrapped for the call. Returns
    (the result, one list of rounds per device, the stability launches,
    host seconds)."""
    from repro_torch.core import cluster
    from repro_torch.kernels import launch_counts, reset_launch_counts

    make, per_device = cluster.make_scheduler, []

    def recorded(*args, **kwargs):
        sched = make(*args, **kwargs)
        per_device.append(record_rounds(sched))
        return sched

    cluster.make_scheduler = recorded
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run(arrivals, spec.horizon, warmup_tasks=spec.warmup_tasks)
        seconds = time.perf_counter() - t0
        launches = launch_counts["stability_score"]
    finally:
        cluster.make_scheduler = make
    return res, per_device, launches, seconds


def _conserved(res, arrivals):
    m = res.metrics
    return len(res.completions) + m.dropped + m.residual_queue == len(
        arrivals)


def phase_fleet(device):
    """The four fig14 cells through ``SweepRunner.run_cell``, each with the
    ``numpy`` and the ``cuda`` scoring backend, then again through the
    cell's ``ClusterSimulator`` with every device's rounds recorded. The
    numpy runs must hold the fig14 goldens at rtol 1e-9 (quoted strings
    too); the ``cuda`` runs must decide as the numpy shadow does on the same
    snapshots and per-device tables (float32 ties aside) and, with no tie,
    give the numpy cell's metrics; the stability kernel must launch once per
    scoring round, summed over the devices; completed + dropped + residual
    must equal the arrivals. Then the het stability-aware cell with device
    1 failing at 2 s, traced, under ``cuda``: its failure and fail-over
    events, its spans (one per arrival), its metrics equal to the numpy
    run's, and launches = scoring rounds + traced rounds with two or more
    candidates (``decision_margin`` scores each such round again). Returns
    the kernel's launches in the ``run_cell`` runs and the fail-over run."""
    import torch

    from repro_torch.core import ProfileTable, SweepRunner, SweepSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts

    on_card = torch.device(device).type == "cuda"
    golden = json.loads(GOLDEN.read_text())["fig14"]
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    total_launches, t_phase = 0, time.perf_counter()
    for name in FIG14_CELLS:
        runs = {}
        for backend in ("numpy", "cuda"):
            spec = SweepSpec(**fig14_fields(name), backend=backend,
                             device=device)
            reset_launch_counts()
            cell = runner.run_cell(spec)
            launches = launch_counts["stability_score"]
            arrivals = runner.arrivals(spec)
            res, per_device, recorded_launches, recorded_s = (
                run_recorded_cluster(runner.simulator(spec), arrivals, spec))
            scored = [[r for r in rounds if r[0].nonempty()]
                      for rounds in per_device]
            n_scored = sum(len(sc) for sc in scored)
            check(res.metrics == cell.metrics,
                  f"{name}/{backend}: the recorded run differs from run_cell")
            want = n_scored if on_card and backend == "cuda" else 0
            check(launches == want and recorded_launches == want,
                  f"{name}/{backend}: stability launches {launches} and "
                  f"{recorded_launches}, want {want} (scoring rounds "
                  f"{n_scored} over {len(scored)} devices)")
            check(_conserved(res, arrivals),
                  f"{name}/{backend}: completed + dropped + residual != "
                  f"arrivals")
            runs[backend] = dict(cell=cell, scored=scored,
                                 launches=launches, recorded_s=recorded_s)
        total_launches += runs["cuda"]["launches"]
        f64, f32 = runs["numpy"], runs["cuda"]
        got, want = f64["cell"].metrics.violation_ratio, golden[name]
        check(bool(np.isclose(got, want["violation_ratio"],
                              rtol=GOLDEN_RTOL, atol=0.0))
              and f"{got * 100:.2f}%" == want["quoted"],
              f"{name}: golden {got!r} != {want['violation_ratio']!r} "
              f"({want['quoted']})")
        _, ties = shadow_check(f"fleet_shadow/{name}",
                               [r for sc in f32["scored"] for r in sc],
                               max_batch=10)
        if ties == 0:
            check(f32["cell"].metrics == f64["cell"].metrics,
                  f"{name}: cuda metrics differ from numpy with no tie")
        emit("fleet", cell=name, title=f32["cell"].spec.title(),
             arrivals=len(arrivals), devices=len(f32["scored"]),
             scoring_rounds=[len(sc) for sc in f32["scored"]],
             kernel_launches=f32["launches"], float32_ties=ties,
             violation_ratio={b: runs[b]["cell"].metrics.violation_ratio
                              for b in runs},
             quoted=want["quoted"],
             round_us_per_device={
                 b: [_round_us(sc)["mean"] if sc else None
                     for sc in runs[b]["scored"]] for b in runs},
             wall_s={b: runs[b]["cell"].us_per_call / 1e6 for b in runs},
             recorded_s={b: runs[b]["recorded_s"] for b in runs},
             dispatch_counts=[d.dispatched
                              for d in f32["cell"].metrics.per_device])
    # the fail-over cell, traced
    runs = {}
    for backend in ("numpy", "cuda"):
        spec = SweepSpec(**fig14_fields(FIG14_CELLS[0]), fail_at=FAIL_AT,
                         backend=backend, device=device, trace=True)
        arrivals = runner.arrivals(spec)
        res, per_device, launches, seconds = run_recorded_cluster(
            runner.simulator(spec), arrivals, spec)
        runs[backend] = dict(res=res, launches=launches, seconds=seconds,
                             scored=sum(len([r for r in rounds
                                             if r[0].nonempty()])
                                        for rounds in per_device))
    f64, f32 = runs["numpy"], runs["cuda"]
    trace = f32["res"].trace
    kinds = [e.kind for e in trace.events]
    failure = [e for e in trace.events if e.kind == "device-failure"]
    counts = trace.span_counts()
    rescored = sum(1 for r in trace.decisions if math.isfinite(r.margin))
    want = f32["scored"] + rescored if on_card else 0
    emit("fleet_failover", cell=FIG14_CELLS[0], fail_at=list(FAIL_AT),
         arrivals=len(arrivals), spans=counts, events=kinds.count("failover"),
         orphans=failure[0].payload_dict()["orphans"] if failure else None,
         scoring_rounds=f32["scored"], rescored_rounds=rescored,
         kernel_launches=f32["launches"], seconds=f32["seconds"],
         violation_ratio={b: runs[b]["res"].metrics.violation_ratio
                          for b in runs},
         alive=[d.alive for d in f32["res"].metrics.per_device])
    check(len(failure) == 1 and kinds.count("failover") == 1
          and failure[0].device == 1 and failure[0].t == FAIL_AT[0][1],
          f"fail-over events {kinds}")
    check(not f32["res"].metrics.per_device[1].alive, "device 1 still alive")
    check(len(trace.spans) == len(arrivals) == trace.meta["n_arrivals"]
          and counts["completed"] == len(f32["res"].completions)
          and counts["dropped"] == f32["res"].metrics.dropped
          and counts["residual"] == f32["res"].metrics.residual_queue,
          f"fail-over spans {counts} against {len(arrivals)} arrivals")
    check(f32["res"].metrics == f64["res"].metrics,
          "fail-over cell: cuda metrics differ from numpy")
    check(f32["launches"] == want,
          f"fail-over cell: stability launches {f32['launches']}, want "
          f"{want} (scoring rounds {f32['scored']} + re-scored {rescored})")
    emit("fleet_phase", seconds=time.perf_counter() - t_phase)
    return total_launches + f32["launches"]


# ---------------------------------------------------------------------------
# Phase 7b: the compiled scan tiers (simfast, clusterfast, seedband)
# ---------------------------------------------------------------------------

# benchmarks/fig17_seedband.py: the grid cell (fig4's lambda = 140 at 10 s,
# 1000 seeds in chunks of 100) and the fig14 heterogeneous fleet cell (MMPP
# lambda_152 = 640 over 6 s, 4 devices, ring width 128); its smoke cells
# (REPRO_FIG17_SMOKE) are the card-against-CPU check
SCAN_GRID = dict(lam=140.0, horizon=10.0, seeds=1000, chunk=100)
SCAN_FLEET = dict(lam=640.0, horizon=6.0, seeds=64, chunk=64, size=4,
                  max_queue=128)
SCAN_SMOKE_GRID = dict(lams=(100.0, 220.0), horizon=2.0, seeds=8, chunk=4)
SCAN_SMOKE_FLEET = dict(horizon=1.5, seeds=6, chunk=3)
SCAN_DISPATCHERS = ("stability-aware", "jsq")
SCAN_PY_SAMPLE = 2        # lanes held against the Python engine per cell
NEAR_TIE_RTOL = 1e-12     # runner-up margin <= this times |winner's score|


def _blocks_vs_eager(plan, make, max_queue=None):
    """Two step objects from one plan: one runs each block of the first
    chunk op by op, the other replays it as its captured graph (on the
    card). Returns (blocks, mismatches): outputs and carry must agree
    bitwise."""
    import torch

    key = plan.key(plan.first_window(max_queue))
    eager, graphed = make(key), make(key)
    plan.load(eager)
    plan.load(graphed)
    blocks = key.chunk_steps // graphed.graph_steps
    mismatches = 0
    for _ in range(blocks):
        want = eager.eager()
        got = graphed.advance()
        mismatches += not (
            all(torch.equal(g, w) for g, w in zip(got, want))
            and all(torch.equal(g, w)
                    for g, w in zip(graphed.carry, eager.carry)))
    check(graphed.device.type != "cuda" or graphed.graph is not None,
          "scan: no graph was captured")
    return blocks, mismatches


def _scan_decisions(res):
    return [(t.t_start, t.decision.model, t.decision.exit_idx,
             t.decision.batch_size) for t in res.traces]


def _ties(decisions):
    """(exact ties, float64 near-ties) among decision records: runner-up
    margin 0, and 0 < margin <= NEAR_TIE_RTOL * |winner's score|."""
    exact = sum(1 for d in decisions if d.margin == 0.0)
    near = sum(1 for d in decisions
               if 0.0 < d.margin <= NEAR_TIE_RTOL * abs(d.score))
    return exact, near


def _scan_vs_python(sched_fn, table, lanes, horizon, device):
    """Lanes through the scan on ``device`` (traced) and through the port's
    ServingSimulator: decisions and metrics must agree. Returns the Python
    engine's per-lane seconds and the (exact, near) ties of each lane."""
    from repro_torch.core import ServingSimulator, Tracer, simulate_scan_batch

    tracers = [Tracer() for _ in lanes]
    scan = simulate_scan_batch(sched_fn(), table, lanes, horizon,
                               keep_traces=True, tracers=tracers,
                               device=device)
    py_s, ties = [], []
    for lane, res, tr in zip(lanes, scan, tracers):
        t0 = time.perf_counter()
        py = ServingSimulator(sched_fn(), table, num_models=3).run(
            lane, horizon, keep_traces=True)
        py_s.append(time.perf_counter() - t0)
        check(_scan_decisions(res) == _scan_decisions(py),
              "scan: decisions differ from the Python engine")
        check(res.metrics == py.metrics,
              "scan: metrics differ from the Python engine")
        ties.append(_ties(res.trace.decisions))
    return scan, py_s, ties


def _fleet_python(dispatcher, fleet, lane, tracer=None):
    """One lane of fig17's fleet cell through the port's
    ``ClusterSimulator``."""
    from repro_torch.core import (
        ClusterSimulator,
        ProfileTable,
        SchedulerConfig,
        make_dispatcher,
        make_fleet,
    )

    size = fleet["size"]
    return ClusterSimulator(
        make_fleet("heterogeneous", size, ProfileTable.paper_rtx3080()),
        config=SchedulerConfig(slo=SLO),
        dispatcher=make_dispatcher(dispatcher, slo=SLO, power_d=size),
        tracer=tracer).run(lane, fleet["horizon"])


def _fleet_lanes(fleet, seeds):
    from repro_torch.core import make_scenario, paper_rate_vector

    proc = make_scenario("mmpp", paper_rate_vector(fleet["lam"]))
    return [proc.generate(fleet["horizon"], seed=s) for s in seeds]


def smoke_cells(smoke_grid):
    """fig17's smoke cells as (kind, policy or dispatcher, lambda): the
    grid at each lambda under edgeserving and, at lambda <= 140,
    allfinal-deadline-aware; the het MMPP fleet under each dispatcher."""
    grid = [("grid", policy, lam) for lam in smoke_grid["lams"]
            for policy in ("edgeserving", "allfinal-deadline-aware")[
                :2 if lam <= 140.0 else 1]]
    return grid + [("fleet", disp, None) for disp in SCAN_DISPATCHERS]


def smoke_name(cell):
    kind, who, lam = cell
    return f"{kind}/{who}" + ("" if lam is None else f"/lam{lam:g}")


def smoke_cell(device, cell, smoke_grid, smoke_fleet, fleet):
    """One smoke cell on ``device``: its per-seed ``ServingMetrics``."""
    from repro_torch.core import (
        ProfileTable,
        SchedulerConfig,
        make_fleet,
        make_scenario,
        make_scheduler,
        paper_rate_vector,
        simulate_cluster_scan_seedband,
        simulate_scan_seedband,
    )

    table, cfg = ProfileTable.paper_rtx3080(), SchedulerConfig(slo=SLO)
    kind, who, lam = cell
    if kind == "grid":
        proc = make_scenario("poisson", paper_rate_vector(lam))
        return simulate_scan_seedband(
            make_scheduler(who, table, cfg), table, proc,
            smoke_grid["horizon"], range(smoke_grid["seeds"]),
            chunk=smoke_grid["chunk"], device=device).metrics
    proc = make_scenario("mmpp", paper_rate_vector(fleet["lam"]))
    seeds = sorted(range(smoke_fleet["seeds"]), key=lambda s: len(
        proc.generate_columns(smoke_fleet["horizon"], seed=s)))
    return simulate_cluster_scan_seedband(
        make_fleet("heterogeneous", fleet["size"], table), proc,
        smoke_fleet["horizon"], seeds, chunk=smoke_fleet["chunk"],
        dispatcher=who, power_d=fleet["size"], config=cfg,
        max_queue=fleet["max_queue"], device=device).metrics


def fleet_ties(dispatcher, fleet, seeds):
    """The (exact, near) ties of the fleet cell's ``seeds`` from a traced
    ``ClusterSimulator`` run (the cluster scan emits no margins; tracing
    changes no decision)."""
    from repro_torch.core import Tracer

    return [_ties(_fleet_python(dispatcher, fleet, lane, Tracer())
                  .trace.decisions) for lane in _fleet_lanes(fleet, seeds)]


def _one_thread():
    import torch

    torch.set_num_threads(1)


def phase_scan(device, grid=SCAN_GRID, fleet=SCAN_FLEET,
               smoke_grid=SCAN_SMOKE_GRID, smoke_fleet=SCAN_SMOKE_FLEET):
    """The compiled scan tiers on ``device`` (lanes of one float64 step,
    each chunk a replayed CUDA graph on the card):

    (a) the fig4 lambda=140 golden cell as ``SweepSpec(engine="scan")``:
        the goldens at rtol 1e-9 (``per_model`` included) and bitwise the
        Python engine's cell (numpy scoring);
    (b) fig17's smoke cells, seed columns on the card == the same calls on
        the CPU;
    (c) graph replay against the eager step: two step objects from one
        plan, at the golden cell's shape and the fleet cell's (each
        dispatcher), every block of the first chunk, outputs and carry
        bitwise;
    (d) fig17's grid cell, 1000 seeds: scan wall time per seed and its host
        split, beside the Python engine's for 2 seeds, whose lanes must
        decide as it does;
    (e) fig17's fleet cell, 64 seeds per dispatcher: the same, the
        ``compare_bands`` gap, and 2 lanes against ``ClusterSimulator``.
    Two spawned workers, one thread each, run the CPU half of (b) and the
    fleet lanes' traced Python runs (for their ties) while the card runs
    (a)-(c), so (a)'s and (b)'s wall times share the host with them; they
    are joined before (d), and nothing else runs while (d) and (e) are
    timed. Every lane compared with the Python engine prints its exact and
    float64 near-ties; any decision mismatch fails the phase. Launches no
    repo kernel."""
    from repro_torch.core import make_scenario, paper_rate_vector
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    reset_launch_counts()
    # fig17 groups the fleet's seeds by arrival count (a chunk pads to its
    # longest lane); the median lanes go to the Python engine
    proc = make_scenario("mmpp", paper_rate_vector(fleet["lam"]))
    lens = {s: len(proc.generate_columns(fleet["horizon"], seed=s))
            for s in range(fleet["seeds"])}
    seeds = sorted(lens, key=lens.get)
    mid = seeds[len(seeds) // 2:len(seeds) // 2 + SCAN_PY_SAMPLE]
    cells = smoke_cells(smoke_grid)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=2, initializer=_one_thread,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        ties = {disp: pool.submit(fleet_ties, disp, fleet, mid)
                for disp in SCAN_DISPATCHERS}
        on_cpu = {cell: pool.submit(smoke_cell, "cpu", cell, smoke_grid,
                                    smoke_fleet, fleet) for cell in cells}
        smoke = _scan_card_checks(device, fleet, smoke_grid, smoke_fleet,
                                  seeds, cells)
        t_sub = time.perf_counter()
        cpu = {cell: f.result() for cell, f in on_cpu.items()}
        ties = {disp: f.result() for disp, f in ties.items()}
        wait_s = time.perf_counter() - t_sub
    for cell in cells:
        check(smoke[cell] == cpu[cell],
              f"scan smoke {smoke_name(cell)}: card != CPU")
    emit("scan_smoke", cells={smoke_name(c): len(smoke[c]) for c in cells},
         card_equals_cpu=True, cpu_wait_s=wait_s)
    _scan_timed(device, grid, fleet, seeds, mid, lens[mid[0]], ties)
    launched = {k: v for k, v in launch_counts.items() if v}
    check(not launched, f"scan: repo kernels launched {launched}")
    emit("scan_phase", seconds=time.perf_counter() - t_phase)


def _scan_card_checks(device, fleet, smoke_grid, smoke_fleet, seeds,
                      cells):
    """(a), the card half of (b), and (c); returns (b)'s columns."""
    from repro_torch.core import (
        ProfileTable,
        SchedulerConfig,
        SweepRunner,
        SweepSpec,
        make_fleet,
        make_scenario,
        make_scheduler,
        paper_rate_vector,
    )
    from repro_torch.core.clusterfast import _ClusterSteps, _plan_cluster
    from repro_torch.core.simfast import _plan_scan, _ScanSteps
    from repro_torch.device import resolve_device

    table = ProfileTable.paper_rtx3080()
    cfg = SchedulerConfig(slo=SLO)

    def sched_fn(policy="edgeserving"):
        return lambda: make_scheduler(policy, table, cfg)

    # (a) the golden cell through the scan sweep cell
    t_sub = time.perf_counter()
    runner = SweepRunner(table)
    fields = dict(policy="edgeserving", rate=140.0, seed=7, horizon=10.0)
    scan_cell = runner.run_cell(SweepSpec(**fields, engine="scan",
                                          device=device))
    py_cell = runner.run_cell(SweepSpec(**fields))
    held = golden_fields("fig4_lam140", scan_cell.metrics)
    for field, got, want in held:
        check(bool(np.isclose(got, want, rtol=GOLDEN_RTOL, atol=0.0)),
              f"scan fig4: golden {field} {got!r} != {want!r}")
    check(scan_cell.metrics == py_cell.metrics,
          "scan fig4: metrics differ from the Python engine's cell")
    golden_lane = runner.arrivals(SweepSpec(**fields))
    _, _, ties_a = _scan_vs_python(sched_fn(), table, [golden_lane], 10.0,
                                   device)
    emit("scan_golden", cell="fig4_lam140", golden_fields_held=len(held),
         equal_to_python_cell=True, ties=ties_a[0],
         wall_s_beside_cpu_workers={"scan": scan_cell.us_per_call / 1e6,
                                   "python": py_cell.us_per_call / 1e6},
         violation_ratio=scan_cell.metrics.violation_ratio,
         seconds=time.perf_counter() - t_sub)

    # (b) fig17's smoke cells on the card; the workers run the same calls
    # on the CPU
    t_sub = time.perf_counter()
    smoke = {cell: smoke_cell(device, cell, smoke_grid, smoke_fleet, fleet)
             for cell in cells}
    smoke_s = time.perf_counter() - t_sub

    # (c) graph replay against the eager step, from plans at the golden
    # cell's and the fleet cell's shapes
    dev = resolve_device(device)
    plan = _plan_scan(sched_fn()(), table, [golden_lane], 10.0, None, None,
                      600.0, None, emit_aux=True)
    checked = {"scan/fig4_lam140": _blocks_vs_eager(
        plan, lambda key: _ScanSteps(key, 1, dev))}
    proc = make_scenario("mmpp", paper_rate_vector(fleet["lam"]))
    lanes = [proc.generate_columns(fleet["horizon"], seed=s)
             for s in seeds[:fleet["chunk"]]]
    for disp in SCAN_DISPATCHERS:
        plan = _plan_cluster(
            make_fleet("heterogeneous", fleet["size"], table), lanes,
            fleet["horizon"], "edgeserving", cfg, disp, fleet["size"], None,
            600.0, None, 0.0, None)
        checked[f"cluster/{disp}"] = _blocks_vs_eager(
            plan, lambda key: _ClusterSteps(key, len(lanes), dev),
            fleet["max_queue"])
    bad = {n: m for n, (_, m) in checked.items() if m}
    check(not bad, f"scan: graph blocks differ from the eager step {bad}")
    emit("scan_blocks", graph_blocks_checked={n: b for n, (b, _)
                                              in checked.items()},
         graph_mismatches=0, smoke_card_s_beside_cpu_workers=smoke_s,
         seconds=time.perf_counter() - t_sub)
    return smoke


def _split(scan_s):
    """The host split of the scan run just timed (seconds per part, and
    the rest: band bookkeeping and step-object set-up)."""
    from repro_torch.core.simfast import split_seconds

    parts = dict(split_seconds)
    return dict(parts, other=scan_s - sum(parts.values()))


def _scan_timed(device, grid, fleet, seeds, mid, mid_arrivals, py_ties):
    """(d) and (e), alone on the host. ``py_ties``: each dispatcher's
    (exact, near) ties of the ``mid`` lanes (``fleet_ties``)."""
    import dataclasses

    import torch

    from repro_torch.core import (
        ProfileTable,
        SchedulerConfig,
        compare_bands,
        make_fleet,
        make_scenario,
        make_scheduler,
        paper_rate_vector,
        simulate_cluster_scan_batch,
        simulate_cluster_scan_seedband,
        simulate_scan_seedband,
    )
    from repro_torch.core.clusterfast import _cluster_steps
    from repro_torch.core.simfast import _scan_steps, split_seconds

    table = ProfileTable.paper_rtx3080()
    cfg = SchedulerConfig(slo=SLO)
    sync = (lambda: torch.cuda.synchronize()) if torch.device(
        device).type == "cuda" else (lambda: None)

    # (d) fig17's grid cell at 1000 seeds
    proc = make_scenario("poisson", paper_rate_vector(grid["lam"]))
    _scan_steps.cache_clear()
    split_seconds.clear()
    sync()
    t0 = time.perf_counter()
    band = simulate_scan_seedband(
        make_scheduler("edgeserving", table, cfg), table, proc,
        grid["horizon"], range(grid["seeds"]), chunk=grid["chunk"],
        device=device)
    sync()
    scan_s = time.perf_counter() - t0
    split = _split(scan_s)
    lanes = [proc.generate(grid["horizon"], seed=s)
             for s in range(SCAN_PY_SAMPLE)]
    scan_lanes, py_s, ties = _scan_vs_python(
        lambda: make_scheduler("edgeserving", table, cfg), table, lanes,
        grid["horizon"], device)
    check([r.metrics for r in scan_lanes]
          == list(band.metrics[:SCAN_PY_SAMPLE]),
          "scan grid: the traced lanes differ from the band's")
    v = band.band("violation_ratio")
    emit("scan_grid", cell=f"edgeserving/lam{grid['lam']:g}",
         seeds=grid["seeds"], chunk=grid["chunk"],
         horizon_s=grid["horizon"],
         scan_s=scan_s, scan_ms_per_seed=scan_s * 1e3 / grid["seeds"],
         host_split_s=split,
         python_ms_per_seed=[s * 1e3 for s in py_s],
         speedup=float(np.mean(py_s)) / (scan_s / grid["seeds"]),
         lanes_vs_python=SCAN_PY_SAMPLE, decision_mismatches=0,
         ties=ties, violation_mean=v.mean, violation_ci=[v.ci_lo, v.ci_hi],
         seconds=time.perf_counter() - t0)

    # (e) fig17's fleet cell, 64 seeds per dispatcher
    t_sub = time.perf_counter()
    proc = make_scenario("mmpp", paper_rate_vector(fleet["lam"]))
    py_lanes = _fleet_lanes(fleet, mid)
    cols, rows = {}, {}
    for disp in SCAN_DISPATCHERS:
        _cluster_steps.cache_clear()
        split_seconds.clear()
        sync()
        t0 = time.perf_counter()
        band = simulate_cluster_scan_seedband(
            make_fleet("heterogeneous", fleet["size"], table), proc,
            fleet["horizon"], seeds, chunk=fleet["chunk"], dispatcher=disp,
            power_d=fleet["size"], config=cfg, max_queue=fleet["max_queue"],
            device=device)
        sync()
        scan_s = time.perf_counter() - t0
        split = _split(scan_s)
        cols[disp] = band.column("violation_ratio")
        py_s, py = [], []
        for lane in py_lanes:
            t0 = time.perf_counter()
            py.append(_fleet_python(disp, fleet, lane))
            py_s.append(time.perf_counter() - t0)
        scan = simulate_cluster_scan_batch(
            make_fleet("heterogeneous", fleet["size"], table), py_lanes,
            fleet["horizon"], config=cfg, dispatcher=disp,
            power_d=fleet["size"], max_queue=fleet["max_queue"],
            device=device)
        for res, want in zip(scan, py):
            check(res.completions == want.completions
                  and res.metrics == want.metrics,
                  f"fleet scan/{disp}: completions or metrics differ from "
                  f"ClusterSimulator")
        v = band.band("violation_ratio")
        rows[disp] = dict(
            scan_s=scan_s, scan_ms_per_seed=scan_s * 1e3 / fleet["seeds"],
            host_split_s=split,
            python_ms_per_seed=[s * 1e3 for s in py_s],
            speedup=float(np.mean(py_s)) / (scan_s / fleet["seeds"]),
            ties=py_ties[disp], violation_mean=v.mean,
            violation_ci=[v.ci_lo, v.ci_hi])
    gap = compare_bands(cols["jsq"], cols["stability-aware"])
    emit("scan_fleet", cell=f"heterogeneous-x{fleet['size']}/mmpp/"
         f"lam{fleet['lam']:g}", seeds=fleet["seeds"],
         horizon_s=fleet["horizon"], arrivals_median=mid_arrivals,
         dispatchers=rows, lanes_vs_python=len(mid), decision_mismatches=0,
         gap_jsq_minus_stability_aware=dataclasses.asdict(gap),
         seconds=time.perf_counter() - t_sub)


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


def _kernel_wrappers():
    """{kernel: (the wrapper, its plain version)}, each taking the inputs
    of ``_lm_kernel_inputs``."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain,
    )
    from repro_torch.kernels.exit_head.ops import exit_head
    from repro_torch.kernels.exit_head.ref import exit_head_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_pair
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    def attention(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal)

    def norm(*args):  # one tensor, or the q/k pair
        return rmsnorm(*args) if len(args) == 2 else rmsnorm_pair(*args)

    def norm_plain(*args):
        return (rmsnorm_plain(*args) if len(args) == 2 else
                (rmsnorm_plain(*args[:2]), rmsnorm_plain(*args[2:])))

    return {"rmsnorm": (norm, norm_plain),
            "flash_attention": (attention, flash_attention_plain),
            "exit_head": (exit_head, exit_head_plain),
            "decode_attention": (decode_attention, decode_attention_plain)}


def run_kernel_cases(cases, dev, gen, f32_timed=frozenset()):
    """Each (kernel, label, shape) of ``cases`` against its plain version
    in bfloat16 and float32, timed in bfloat16 (and in float32 where
    ``(kernel, label)`` is in ``f32_timed``, keyed ``<label>/float32``).
    Returns ({kernel: {dtype: max abs err}}, {kernel: {label: timing}})."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.kernels.exit_head.ops import exit_head_path

    wrappers = _kernel_wrappers()
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in wrappers}
    timings = {k: {} for k in wrappers}
    for kernel, label, shape in cases:
        fn, plain = wrappers[kernel]
        for dname, dtype in dtypes.items():
            args = _lm_kernel_inputs(kernel, shape, dtype, dev, gen)
            got = fn(*args)
            synchronize(dev)
            want = plain(*args)
            errs[kernel][dname] = max(errs[kernel][dname], _lm_compare(
                kernel, args, got, want, dname, label))
            if dname != "bfloat16" and (kernel, label) not in f32_timed:
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
    return errs, timings


def phase_lm_kernels(configs, device):
    """Every LM kernel against its plain version at the served shapes, in
    bfloat16 and float32; bfloat16 times at each shape, and float32 times
    at the shapes of ``F32_TIMED`` (keyed ``<label>/float32``)."""
    import torch

    from repro_torch.kernels.exit_head.ops import exit_head

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs, timings = run_kernel_cases(_lm_kernel_cases(configs), dev, gen,
                                     F32_TIMED)
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
# Phase 8: the LMs on the card against the CPU, float32
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
# Phase 9: KV-cache decode of the LMs on the card against the CPU, float32
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
# Phase 10: live LM serving
# ---------------------------------------------------------------------------


def implied_launches(cfg, exit_idx, step=False):
    """The LM kernels' launches that one served quantum (the trunk through
    exit e, then the exit head) or, with ``step``, one decode step at exit
    e implies for ``cfg``'s family, L = the exit's layers:

    * dense and GQA MoE: rmsnorm 2 L (+L with q/k norm: q and k in one
      launch), flash attention L; a step: decode attention L;
    * MLA (DeepSeek-V3): rmsnorm 4 L (the two latent norms), no attention
      kernel (its attention is plain torch) and no decode attention;
    * Jamba: rmsnorm 2 L, flash attention and decode attention once per
      superblock (its one attention sublayer);
    * RWKV: rmsnorm 3 L (the per-head norm over B x S x H rows), no
      attention;
    * encoder-decoder: rmsnorm 3 L + 2 L_enc + 1 (the encoder's norms and
      its final norm), flash attention L + L_enc (the decoder's causal and
      the encoder's bidirectional self-attention; prefill cross-attention
      is plain torch); a step: rmsnorm 3 L and decode attention 2 L (the
      cached self-attention and the cross-attention over all source
      positions).

    A quantum adds one exit head; a step one rmsnorm (the exit norm)."""
    layers = cfg.exits[exit_idx]
    if cfg.family == "rwkv":
        norms, attn = 3 * layers, 0
    elif cfg.family == "jamba":
        norms, attn = 2 * layers, layers // cfg.attn_period
    elif cfg.family == "encdec":
        norms, attn = 3 * layers, layers
    elif cfg.mla:
        norms, attn = 4 * layers, 0
    else:
        norms, attn = (3 if cfg.qk_norm else 2) * layers, layers
    if step:
        return {"decode_attention": 2 * attn if cfg.family == "encdec"
                else attn, "rmsnorm": norms + 1}
    if cfg.family == "encdec":
        norms += 2 * cfg.num_encoder_layers + 1
        attn += cfg.num_encoder_layers
    return {"rmsnorm": norms, "flash_attention": attn, "exit_head": 1}


def _expected_launches(served, decisions):
    """Launches of each LM kernel implied by the engine's decisions
    (``implied_launches`` of each quantum)."""
    want = {"rmsnorm": 0, "flash_attention": 0, "exit_head": 0}
    for d in decisions:
        for k, n in implied_launches(served[d.model].values.cfg,
                                     d.exit_idx).items():
            want[k] += n
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
    sched = make_scheduler("edgeserving", table, cfg)
    rounds = record_rounds(sched)
    engine = ServingEngine(served, sched)
    engine.warmup()
    arrivals = poisson_arrivals(rates.tolist(), horizon, seed=0)
    reset_launch_counts()
    completions, span = engine.run(arrivals, horizon, drain=True)
    launches = {k: launch_counts[k] for k in KERNELS}
    m = engine.metrics(table, SLO, span)
    decisions = [r[1] for r in rounds if r[1] is not None]
    scored = [r for r in rounds if r[0].nonempty()]
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
    shadow_check("lm_shadow", scored, max_batch=LM_BATCHES[-1])
    lm_breakdown(served)
    return launches, served, table


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "rmsnorm_bwd" in low:
        return "rmsnorm_bwd"
    if "dq_kernel" in low or "dkv_kernel" in low:  # flash_attention_bwd.cu
        return "flash_attention_bwd"
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


def lm_breakdown(served, emit_line=True, runs=5):
    """Where a quantum's time goes, at the final exit and B = 1 and 8: the
    host-clock time of a quantum (median of ``runs``, no profiler), and
    from one
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
            for _ in range(runs):
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
    if emit_line:
        emit("lm_breakdown", rows=rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 11: KV-cache decode of the served LMs, bfloat16, full size
# ---------------------------------------------------------------------------


def _decode_launches_implied(cfg, exit_idx, steps):
    """Launches a run of decode steps implies (``implied_launches`` of a
    step, ``steps`` times)."""
    return {k: steps * n for k, n in
            implied_launches(cfg, exit_idx, step=True).items()}


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
            prompt = mod.data_fn(b)["tokens"]
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
# Phase 12: the serve_multi_model LMs live, with a tracer and a profiler
# ---------------------------------------------------------------------------

MULTI_EXAMPLE = ROOT / "examples_torch" / "serve_multi_model.py"
MULTI_RATE = 150.0  # the reference example's default, req/s at 3:2:1
MULTI_SEED = 42     # the reference example's trace seed
MULTI_REFRESH_S = 0.25


def load_multi_example():
    """``examples_torch/serve_multi_model.py`` as a module (its
    ``deployment_configs`` and ``make_deployment``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("serve_multi_model",
                                                  MULTI_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _multi_kernel_checks(served, device):
    """The LM kernels against their plain versions at the shapes these
    models serve, in float32 (their dtype) and bfloat16: rmsnorm rows of
    B x 16 and the exit-norm rows of B at D = 64, 128; flash attention at
    B, 4 heads, 2 kv heads, S = 16 and D = 16, 32 (the CUDA-core float32
    kernel; the served-shape checks of phase 3 run D = 64 and 128 only);
    the exit head at T = B, V = 512. The float32 cases at B = 8 are timed
    (CUDA-graph replay) beside the bound, the plain version and the library
    call. Returns ({kernel: max abs err}, {kernel: {label: timing}})."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.kernels.exit_head.ops import exit_head
    from repro_torch.kernels.exit_head.ref import exit_head_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    def attention(q, k, v, causal):
        return flash_attention(q, k, v, causal=causal)

    wrappers = {"rmsnorm": (rmsnorm, rmsnorm_plain),
                "flash_attention": (attention, flash_attention_plain),
                "exit_head": (exit_head, exit_head_plain)}
    cases = []
    for mod in served:
        cfg = mod.values.cfg
        for b in LM_BATCHES:
            tag = f"{mod.name}/b{b}"
            cases += [("rmsnorm", f"{tag}/rows", (b * 16, cfg.d_model)),
                      ("rmsnorm", f"{tag}/exit", (b, cfg.d_model)),
                      ("flash_attention", f"{tag}/d{cfg.head_dim_}",
                       (b, cfg.num_heads, cfg.num_kv_heads, 16,
                        cfg.head_dim_, True)),
                      ("exit_head", tag, (b, cfg.d_model, cfg.vocab_size))]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in wrappers}
    timings = {k: {} for k in wrappers}
    for kernel, label, shape in cases:
        fn, plain = wrappers[kernel]
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            args = _lm_kernel_inputs(kernel, shape, dtype, dev, gen)
            got = fn(*args)
            synchronize(dev)
            errs[kernel][dname] = max(errs[kernel][dname], _lm_compare(
                kernel, args, got, plain(*args), dname, label))
            if dname != "float32" or not label.split("/")[1].endswith(
                    f"b{LM_BATCHES[-1]}") or dev.type != "cuda":
                continue
            nbytes, ops, rate = _lm_kernel_cost(kernel, shape, dtype, args)
            bound, bound_by = _bound_ms(nbytes, ops, rate)
            lib = _lm_library(kernel, args)
            timings[kernel][f"lm_multi/{label}"] = dict(
                shape=list(shape), dtype=dname,
                ms=graph_ms(lambda: fn(*args), 20),
                plain_ms=cuda_ms(lambda: plain(*args), 5),
                library_ms=None if lib is None else cuda_ms(lib, 20),
                bound_ms=bound, bound_by=bound_by)
    return errs, timings


def _tracestats(path):
    """``tools/tracestats.py`` on one export; its exit code and the head
    of what it printed."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "tracestats.py"), str(path),
         "--top", "3", "--bins", "5"],
        capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout.splitlines()[:3] + out.stderr.splitlines(
    )[-3:]


def phase_lm_multi(device, duration=HORIZON_S):
    """The three LMs of ``examples/serve_multi_model.py`` (built by the
    port's example, float32, on the card): each model's ``forward_exit`` and
    served quantum against the same module on the CPU at every exit; the
    LM kernels against their plain versions at these models' shapes (flash
    attention at D = 16 and 32); ``measure_profile`` over B in {1, 2, 4, 8};
    then a Poisson 3:2:1 trace at 150 req/s for ``duration`` s served by
    ``ServingEngine`` with the ``cuda`` backend, an ``OnlineProfiler`` and a
    ``Tracer``, and a float64 numpy shadow on the same snapshots and tables.
    Checks: no decision differs from the shadow beyond float32 ties; each
    LM kernel's launches equal the count the quanta imply, and the
    stability kernel's the scoring rounds plus the traced rounds with two
    or more candidates; ``profiler_refreshes`` equals the trace's refresh
    events; one span per arrival; ``tools/tracestats.py`` reads both
    exports. Returns the launches of the served run, by kernel."""
    import copy

    import torch

    from repro_torch.core import (
        AdaptConfig,
        OnlineProfiler,
        SchedulerConfig,
        Tracer,
        export_chrome_trace,
        export_ndjson,
        make_scheduler,
        poisson_arrivals,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime.server import ServingEngine, measure_profile

    t_phase = time.perf_counter()
    example = load_multi_example()
    served = example.make_deployment(device)
    errs = {}
    for mod in served:
        cfg = mod.values.cfg
        errs.update(_lm_check_pair(copy.deepcopy(mod.values), 4,
                                   example.PROMPT_LEN, range(cfg.num_exits),
                                   mod.name))
    kernel_errs, timings = _multi_kernel_checks(served, device)
    emit("lm_multi_models", max_abs_err_vs_cpu=errs, tol=LM_TOL["float32"],
         kernel_max_abs_err=kernel_errs, kernel_timings=timings,
         head_dims=[m.values.cfg.head_dim_ for m in served])

    for mod in served:  # one untimed pass over every cell (clocks)
        for e in range(mod.num_exits):
            for b in LM_BATCHES:
                mod.forward_fn(mod.values, mod.data_fn(b), e)
    table = measure_profile(served, batch_sizes=list(LM_BATCHES), repeats=5,
                            warmup=2)
    slo = float(table.latency.max() * 5)  # the example's SLO rule
    cfg = SchedulerConfig(slo=slo, max_batch=LM_BATCHES[-1], backend="cuda",
                          device=device)
    sched = make_scheduler("edgeserving", table, cfg)
    rounds = record_rounds(sched)
    tracer = Tracer()
    engine = ServingEngine(
        served, sched,
        profiler=OnlineProfiler(table, AdaptConfig(
            refresh_every=MULTI_REFRESH_S)),
        tracer=tracer)
    engine.warmup(list(LM_BATCHES))
    del rounds[:]
    unit = MULTI_RATE / 6.0
    arrivals = poisson_arrivals([3 * unit, 2 * unit, unit], duration,
                                seed=MULTI_SEED)
    reset_launch_counts()
    completions, span = engine.run(arrivals, duration, drain=True)
    launches = {k: launch_counts[k] for k in KERNELS}
    m = engine.metrics(table, slo, span)
    trace = engine.trace(horizon=duration, span=span,
                         warmup_used=m.warmup_used, n_arrivals=len(arrivals))
    decisions = [r[1] for r in rounds if r[1] is not None]
    scored = [r for r in rounds if r[0].nonempty()]
    rescored = sum(1 for r in trace.decisions if math.isfinite(r.margin))
    want = _expected_launches(served, decisions)
    want["stability_score"] = len(scored) + rescored
    refresh_events = [e for e in trace.events if e.kind == "profiler-refresh"]
    with tempfile.TemporaryDirectory() as tmp:
        exports = {"ndjson": export_ndjson(trace, f"{tmp}/live.ndjson"),
                   "chrome": export_chrome_trace(trace, f"{tmp}/live.json")}
        stats = {k: _tracestats(p) for k, p in exports.items()}
    lat_ms = table.latency * 1e3
    emit("lm_multi_serve", arrivals=len(arrivals),
         completed=len(completions), dropped=engine.dropped,
         residual=m.residual_queue, span_s=span, slo_ms=slo * 1e3,
         b1_ms={f"{table.model_names[i]}/{table.exit_names[e]}":
                float(lat_ms[i, e, 0]) for i in range(len(served))
                for e in range(table.num_exits)},
         p95_ms=m.p95_latency * 1e3, p50_ms=m.p50_latency * 1e3,
         violation_ratio=m.violation_ratio,
         mean_exit_depth=m.mean_exit_depth, utilization=m.utilization,
         mean_batch=m.mean_batch, quanta=len(decisions),
         scoring_rounds=len(scored), rescored_rounds=rescored,
         counters=engine.counters, refresh_events=len(refresh_events),
         tables=len({id(r[2]) for r in rounds}),
         spans=trace.span_counts(), launches=launches,
         launches_implied=want, tracestats=stats)
    check(len(completions) + engine.dropped + m.residual_queue
          == len(arrivals), "lm_multi arrivals not conserved")
    check(len(trace.spans) == len(arrivals),
          f"{len(trace.spans)} spans for {len(arrivals)} arrivals")
    check(len(decisions) > 0, "no lm_multi quantum ran")
    check(engine.counters["profiler_refreshes"] == len(refresh_events) > 0,
          f"profiler_refreshes {engine.counters['profiler_refreshes']} vs "
          f"{len(refresh_events)} refresh events")
    for kernel, n in want.items():
        n = n if torch.device(device).type == "cuda" else 0
        check(launches[kernel] == n,
              f"lm_multi {kernel} launches {launches[kernel]} != {n} "
              f"implied")
    for kind, (rc, lines) in stats.items():
        check(rc == 0, f"tracestats on the {kind} export: rc {rc} {lines}")
    shadow_check("lm_multi_shadow", scored, max_batch=LM_BATCHES[-1],
                 slo=slo)
    breakdown = lm_breakdown(served)
    emit("lm_multi_phase", seconds=time.perf_counter() - t_phase,
         idle_share={k: v["idle_share"] for k, v in breakdown.items()})
    return launches, timings


# ---------------------------------------------------------------------------
# Phase lm_zoo: the rest of the model zoo (MoE, MLA, Jamba, RWKV-6, the
# encoder-decoder, StarCoder2, LLaVA-NeXT)
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b",
             "rwkv6-1.6b", "seamless-m4t-large-v2", "starcoder2-7b",
             "llava-next-mistral-7b")
# (a) float32, card against CPU, at full width: depth and the routed
# experts cut to what the CPU holds in float32 beside the card's copy
ZOO_F32_CUTS = {
    "deepseek-moe-16b": dict(num_layers=3, exits=(2, 3)),
    "deepseek-v3-671b": dict(num_layers=3, exits=(2, 3), dense_prefix=1,
                             num_experts=16),
    "jamba-v0.1-52b": dict(num_layers=8, exits=(8,), num_experts=4),
    "rwkv6-1.6b": dict(num_layers=4, exits=(2, 4)),
    "seamless-m4t-large-v2": dict(num_layers=2, num_encoder_layers=2,
                                  exits=(1, 2)),
    "starcoder2-7b": dict(num_layers=2, exits=(1, 2)),
    "llava-next-mistral-7b": dict(num_layers=2, exits=(1, 2)),
}
ZOO_F32 = dict(batch=2, seq=16, prompt=8, steps=8)
# (b) bfloat16 at full width, one model at a time: the two depth cuts one
# card's 80 GB forces
ZOO_BF16_CUTS = {"jamba-v0.1-52b": dict(num_layers=16, exits=(8, 16)),
                 "deepseek-v3-671b": dict(num_layers=5, exits=(4, 5))}
ZOO_DECODE_STEPS = 16
# (c) one live deployment of four families that fit on the card together,
# with Poisson traffic 4:3:2:1 in this order
ZOO_LIVE = ("rwkv6-1.6b", "seamless-m4t-large-v2", "starcoder2-7b",
            "deepseek-moe-16b")
ZOO_LIVE_SPLIT = (4.0, 3.0, 2.0, 1.0)
ZOO_PROFILE = dict(repeats=3, warmup=1)
# a token whose routed experts differ between the card and the CPU must
# have had its k-th and (k+1)-th router scores this close on the CPU
MOE_TIE_RTOL = 1e-5


def _zoo_kernel_cases():
    """The kernel shapes the zoo's served quanta and decode steps give, at
    B = 8 (and B = 1 where the kernel's plan changes): GQA group 9
    (StarCoder2) and 1 (DeepSeek-MoE's MHA), head dim 64 (Seamless), the
    encoder's non-causal attention over 1024 frames, LLaVA's 2880
    patches, rmsnorm rows of 7168, 1536 and 512 (V3, its latent norms)
    and 64 (RWKV's per-head norm, 32768 rows), and exit heads up to
    D = 7168 / V = 129280 and V = 256206 (whose bfloat16 rows are not
    16-byte multiples)."""
    b, s, dec = 8, LM_PROMPT, LM_PROMPT + ZOO_DECODE_STEPS
    cases = [
        ("flash_attention", "starcoder2-7b/prefill", (b, 36, 4, s, 128, True)),
        ("flash_attention", "deepseek-moe-16b/prefill",
         (b, 16, 16, s, 128, True)),
        ("flash_attention", "seamless/encoder_s1024",
         (b, 16, 16, 1024, 64, False)),
        ("flash_attention", "seamless/decoder", (b, 16, 16, s, 64, True)),
        ("flash_attention", "llava/prefill_s2880_b1",
         (1, 32, 8, 2880, 128, True)),
        ("decode_attention", "starcoder2-7b/step_b1", (1, 36, 4, dec, 128, 1)),
        ("decode_attention", "starcoder2-7b/step",
         (b, 36, 4, dec, 128, 1)),
        ("decode_attention", "deepseek-moe-16b/step_b1",
         (1, 16, 16, dec, 128, 1)),
        ("decode_attention", "seamless/self_b1", (1, 16, 16, dec, 64, 1)),
        ("decode_attention", "seamless/cross_s1024_b1",
         (1, 16, 16, 1024, 64, 1)),
        ("decode_attention", "jamba/step_b1", (1, 32, 8, dec, 128, 1)),
        ("rmsnorm", "deepseek-v3/residual", (b * s, 7168)),
        ("rmsnorm", "deepseek-v3/q_a_norm", (b * s, 1536)),
        ("rmsnorm", "deepseek-v3/kv_a_norm", (b * s, 512)),
        ("rmsnorm", "rwkv6/head_norm", (b * s * 32, 64)),
        ("rmsnorm", "rwkv6/head_norm_decode_b1", (32, 64)),
        ("rmsnorm", "seamless/encoder", (b * 1024, 1024)),
        ("rmsnorm", "starcoder2-7b/residual", (b * s, 4608)),
        ("exit_head", "deepseek-v3/served", (b, 7168, 129280)),
        ("exit_head", "deepseek-v3/served_t1", (1, 7168, 129280)),
        ("exit_head", "seamless/served", (b, 1024, 256206)),
        ("exit_head", "deepseek-moe-16b/served", (b, 2048, 102400)),
        ("exit_head", "starcoder2-7b/served", (b, 4608, 49152)),
        ("exit_head", "rwkv6/served", (b, 2048, 65536)),
    ]
    return cases


def _zoo_batch(cfg, b, s, device, seed):
    """A seeded batch of ``cfg``'s family (``serve_lms``'s payload) with
    ``s`` target tokens (or patches), drawn on the CPU and moved."""
    import torch

    from repro_torch.runtime.server import lm_payload

    gen = torch.Generator().manual_seed(seed)
    return {k: v.to(device) for k, v in
            lm_payload(cfg, gen, s, b).items()}


def _blocks(model):
    """(label, fn(h) -> h) for each block whose output may depend on
    routing: every layer of a DecoderLM, every sublayer of a JambaLM."""
    from repro_torch.models.jamba_model import sub_kinds
    from repro_torch.models.transformer import _block_apply

    cfg = model.cfg
    if cfg.family == "jamba":
        for i, seg in enumerate(model.segments):
            for n, sb in enumerate(seg):
                for j, kind in enumerate(sub_kinds(cfg)):
                    yield (f"seg{i}/sb{n}/sub{j}",
                           lambda h, sub=sb[f"sub{j}"], kind=kind:
                           model.sublayer_apply(sub, kind, h, None,
                                                False)[0])
    else:
        for i, seg in enumerate(model.segments):
            for n, blk in enumerate(seg):
                yield (f"seg{i}/layer{n}",
                       lambda h, blk=blk: _block_apply(blk, h, cfg,
                                                       False)[0])


def _route_diff(card_log, cpu_log):
    """Compare two runs' routing logs call by call. Returns (per call a
    bool mask of the tokens routed alike, with the same experts kept;
    the flips: (call, token, the CPU's relative k-th/(k+1)-th margin) of
    tokens whose expert set differs; the tokens whose experts agree but
    whose capacity slots do not)."""
    import torch

    agree, flips, shifted = [], [], 0
    for c, (a, b) in enumerate(zip(card_log, cpu_log)):
        a = {k: v.cpu() for k, v in a.items()}
        b = {k: v.cpu() for k, v in b.items()}
        ia, ib = a["idx"], b["idx"]
        ka = torch.where(a["kept"], ia, -1).sort(-1).values
        kb = torch.where(b["kept"], ib, -1).sort(-1).values
        same_set = (ia.sort(-1).values == ib.sort(-1).values).all(-1)
        same = same_set & (ka == kb).all(-1)
        margin = (b["kth"] - b["next"]) / b["kth"].abs().clamp(min=1e-30)
        for t in torch.nonzero(~same_set).flatten().tolist():
            flips.append((c, t, float(margin[t])))
        shifted += int((same_set & ~same).sum())
        agree.append(same)
    return agree, flips, shifted


def _check_flips(label, flips):
    """Every flip a near-tie on the CPU's scores."""
    bad = [f for f in flips if f[2] > MOE_TIE_RTOL]
    check(not bad, f"{label}: routing flips beyond a near-tie "
                   f"(call, token, margin): {bad[:5]}")


def _held_run(label, run_card, run_cpu):
    """Run ``run_card()`` and ``run_cpu()`` under ``record_routing``; the
    first routing call that differs must differ only on near-ties. Returns
    (card out, CPU out, routed alike everywhere, the flips)."""
    from repro_torch.models.moe import record_routing

    with record_routing() as log_card:
        got = run_card()
    with record_routing() as log_cpu:
        want = run_cpu()
    check(len(log_card) == len(log_cpu), f"{label}: routing calls "
          f"{len(log_card)} on the card, {len(log_cpu)} on the CPU")
    agree, flips, shifted = _route_diff(log_card, log_cpu)
    first = next((c for c, a in enumerate(agree) if not bool(a.all())), None)
    if first is not None:
        _check_flips(label, [f for f in flips if f[0] == first])
    return got, want, first is None, [f for f in flips if f[0] == first]


def _zoo_blockwise(arch, model, twin, batch, tol):
    """Feed each block of the card's model the CPU's input to that block;
    compare the routed experts token by token and hold the outputs of the
    tokens routed alike at ``tol`` relative to each token's largest output
    element (``tol * (1 + max |row|)``). Returns (the largest error over
    ``1 + max |row|``, flips, tokens
    whose capacity slots moved, the CPU's hidden state after each block)."""
    import torch

    from repro_torch.models.moe import record_routing

    dev = model.embed.device
    with torch.inference_mode():
        h_cpu = twin._embed({k: v.cpu() for k, v in batch.items()})
        err, flips, shifted, states = 0.0, [], 0, []
        for (label, f_card), (_, f_cpu) in zip(_blocks(model),
                                               _blocks(twin)):
            label = f"{arch}/{label}"
            with record_routing() as log_cpu:
                out_cpu = f_cpu(h_cpu)
            with record_routing() as log_card:
                out_card = f_card(h_cpu.to(dev)).cpu()
            agree, fl, sh = _route_diff(log_card, log_cpu)
            _check_flips(label, fl)
            flips += fl
            shifted += sh
            d = out_cpu.shape[-1]
            keep = agree[0] if agree else torch.ones(
                out_cpu.reshape(-1, d).shape[0], dtype=torch.bool)
            g, w = out_card.reshape(-1, d)[keep], out_cpu.reshape(-1, d)[keep]
            check(bool(torch.isfinite(out_card).all()),
                  f"{label}: not finite on the card")
            # each token's error against its own largest output: the
            # reference's expert init (fan-in = the expert count) drives
            # MoE outputs to 1e3-1e5, where float32 rounding alone leaves
            # more than 2e-3 on the elements that cancel to near zero
            bad = ((g - w).abs().amax(-1)
                   > tol + tol * w.abs().amax(-1))
            check(not bool(bad.any()),
                  f"{label}: card and CPU block outputs differ by "
                  f"{float((g - w).abs().max())} on tokens "
                  f"{torch.nonzero(keep).flatten()[bad].tolist()} of "
                  f"{int(keep.sum())} routed alike; flips {fl}, capacity "
                  f"moves {sh}")
            err = max(err, float(((g - w).abs().amax(-1)
                                   / (1 + w.abs().amax(-1))).max()))
            h_cpu = out_cpu
            states.append(out_cpu)
    return err, flips, shifted, states


def _into_buffers(buf, pref, prompt):
    """Copy a prefill's caches ``pref`` into ``init_cache``'s buffers
    ``buf`` (the same nested structure): position-indexed leaves (k, v,
    MLA's latent) at positions < prompt, the rest (lengths, states,
    cross-attention K/V) whole."""
    if isinstance(buf, dict):
        for key in buf:
            _into_buffers(buf[key], pref[key], prompt)
    elif isinstance(buf, list):
        for b, p in zip(buf, pref):
            _into_buffers(b, p, prompt)
    elif buf.shape == pref.shape:
        buf.copy_(pref)
    else:
        buf[:, :, :prompt] = pref
    return buf


def _init_cache(model, batch, b, max_len, e):
    kw = ({"src_len": batch["src_embeds"].shape[1]}
          if model.cfg.family == "encdec" else {})
    return model.init_cache(b, max_len, e, **kw)


def _prompt(batch, n):
    """The first ``n`` target positions of a batch."""
    return {k: (v if k == "src_embeds" else v[:, :n])
            for k, v in batch.items()}


def _step_input(batch, i):
    """The teacher-forced input of position i: a token, or an embedding."""
    return (batch["embeds"][:, i:i + 1] if "embeds" in batch
            else batch["tokens"][:, i:i + 1])


def _cache_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _cache_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _cache_leaves(v)
    else:
        yield tree


def _teacher_forced_zoo(model, batch, prompt, steps, max_len, e,
                        prepared=False):
    """Prefill the first ``prompt`` positions into ``init_cache`` buffers
    (or, with ``prepared``, start from the encoder-decoder's
    ``prepare_decode_cache`` with an empty self-attention cache and decode
    from position 0), then decode the next positions teacher-forced.
    Returns [per step the CPU copy of its logits] and the final cache on
    the CPU."""
    import torch

    b = next(iter(batch.values())).shape[0]
    outs = []
    with torch.inference_mode():
        if prepared:
            cache = model.prepare_decode_cache(batch["src_embeds"], b,
                                               max_len, e)
            start = 0
        else:
            logits, pref = model.prefill(_prompt(batch, prompt), e)
            cache = _into_buffers(_init_cache(model, batch, b, max_len, e),
                                  pref, prompt)
            outs.append(logits.cpu())
            start = prompt
        for i in range(start, prompt + steps):
            logits, cache = model.decode_step(_step_input(batch, i), cache,
                                              e)
            outs.append(logits.cpu())
    cpu_cache = [t.cpu() for t in _cache_leaves(cache)]
    return outs, cpu_cache


def _compare(label, got, want, tol):
    """Max abs error of ``got`` against ``want`` (CPU tensors); raises
    beyond ``tol``."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"{label}: card and CPU differ by {err}")
    return err


def _compare_decision(label, got, want, tol):
    """Exit decisions (token, max, lse): max and lse within ``tol``, the
    token equal or scoring within ``tol`` of the CPU's maximum."""
    import torch

    err = max(_compare(f"{label} exit head max", got[1], want[1], tol),
              _compare(f"{label} exit head lse", got[2], want[2], tol))
    check(bool(torch.all((got[0] == want[0]) | (want[1] - got[1] <= tol))),
          f"{label}: exit token {got[0].tolist()} vs {want[0].tolist()}")
    return err


def _zoo_f32_one(arch, cfg, device):
    """Part (a) for one config: card against CPU in float32. Returns the
    row for the phase's line."""
    import copy
    import dataclasses

    import torch

    from repro_torch.kernels.exit_head.ops import exit_head
    from repro_torch.kernels.exit_head.ref import exit_head_plain
    from repro_torch.models import build_model

    tol = LM_TOL["float32"]
    f = ZOO_F32
    cut = dict(ZOO_F32_CUTS[arch])
    if cfg.frontend == "vision":
        cut["frontend_seq"] = f["prompt"] + f["steps"]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, **cut)
    gen = torch.Generator(device=device).manual_seed(23)
    model = build_model(cfg32, generator=gen, device=device).eval()
    twin = copy.deepcopy(model).to("cpu")
    n = f["prompt"] + f["steps"]
    batch = _zoo_batch(cfg32, f["batch"], n, device, seed=len(arch))
    fwd = {k: (v if k == "src_embeds" else v[:, :f["seq"]])
           for k, v in batch.items()}
    cpu_fwd = {k: v.cpu() for k, v in fwd.items()}
    routed = cfg.family in ("moe", "jamba")
    row = dict(cut={k: v for k, v in cut.items()}, errs={}, flips=[],
               held={})
    if routed:
        err, flips, shifted, states = _zoo_blockwise(arch, model, twin, fwd,
                                                     tol)
        row["errs"]["blocks_per_row_scale"] = err
        row["flips"] += [("blocks",) + fl for fl in flips]
        row["capacity_moves"] = shifted
    with torch.inference_mode():
        for e in range(cfg32.num_exits):
            label = f"{arch}/exit{e}"
            got, want, held, flips = _held_run(
                label, lambda: model.forward_exit(fwd, e).cpu(),
                lambda: twin.forward_exit(cpu_fwd, e))
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"{label}: logits {tuple(got.shape)} or not finite")
            row["held"][f"forward/exit{e}"] = held
            row["flips"] += [(f"forward/exit{e}",) + fl for fl in flips]
            if held:
                row["errs"][f"forward/exit{e}"] = _compare(
                    label, got, want, tol)
            dec, dec_cpu, held, _ = _held_run(
                label, lambda: tuple(x.cpu() for x in
                                     model.exit_decision(fwd, e)),
                lambda: twin.exit_decision(cpu_fwd, e))
            row["held"][f"decision/exit{e}"] = held
            if held:
                row["errs"][f"decision/exit{e}"] = _compare_decision(
                    label, dec, dec_cpu, tol)
            if routed:
                # the exit's head and the exit head kernel on the CPU's own
                # hidden state there: held whatever the routing did
                h = states[cfg32.exits[e] - 1]
                row["errs"][f"head_on_cpu_state/exit{e}"] = _compare(
                    label, model._head(h.to(device), e).cpu(),
                    twin._head(h, e), tol)
                h_last = h[:, -1].contiguous()
                row["errs"][f"decision_on_cpu_state/exit{e}"] = \
                    _compare_decision(
                        label,
                        tuple(x.cpu() for x in exit_head(
                            h_last.to(device), model.exit_norms[e],
                            model.exit_head_weight(), eps=cfg32.norm_eps)),
                        exit_head_plain(h_last, twin.exit_norms[e],
                                        twin.exit_head_weight(),
                                        cfg32.norm_eps), tol)
        # teacher-forced decode, card against CPU and (without routing)
        # against forward_exit over the whole sequence
        e = cfg32.num_exits - 1
        max_len = n + 2
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        forms = [("prefill", False)]
        if cfg.family == "encdec":
            forms.append(("prepared", True))
        full = twin.forward_exit(cpu_batch, e)
        for form, prepared in forms:
            label = f"{arch}/decode/{form}"
            (got, got_cache), (want, want_cache), held, flips = _held_run(
                label, lambda: _teacher_forced_zoo(
                    model, batch, f["prompt"], f["steps"], max_len, e,
                    prepared),
                lambda: _teacher_forced_zoo(
                    twin, cpu_batch, f["prompt"], f["steps"], max_len, e,
                    prepared))
            got, want = torch.cat(got, 1), torch.cat(want, 1)
            check(bool(torch.isfinite(got).all()), f"{label}: not finite")
            row["held"][f"decode/{form}"] = held
            row["flips"] += [(f"decode/{form}",) + fl for fl in flips]
            if held:
                err = _compare(label, got, want, tol)
                e_cache = max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got_cache, want_cache))
                check(all(torch.allclose(g.float(), w.float(), rtol=tol,
                                         atol=tol)
                          for g, w in zip(got_cache, want_cache)),
                      f"{label}: card and CPU caches differ by {e_cache}")
                row["errs"][f"decode/{form}"] = err
                row["errs"][f"decode/{form}/cache"] = e_cache
            if not routed:  # MoE capacity differs between prefill and decode
                first = 0 if prepared else f["prompt"] - 1
                row["errs"][f"decode/{form}/vs_forward_exit"] = _compare(
                    f"{label} against forward_exit", got, full[:, first:n],
                    tol)
        if cfg.mla:  # the absorbed form on the card equals the expanded one
            absorbed = copy.copy(model)
            absorbed.cfg = dataclasses.replace(cfg32,
                                               mla_absorbed_decode=True)
            label = f"{arch}/decode/absorbed"
            (got_a, _), (got_x, _), held, _ = _held_run(
                label, lambda: _teacher_forced_zoo(
                    absorbed, batch, f["prompt"], f["steps"], max_len, e),
                lambda: _teacher_forced_zoo(
                    model, batch, f["prompt"], f["steps"], max_len, e))
            row["held"]["decode/absorbed"] = held
            if held:
                row["errs"]["decode/absorbed_vs_expanded"] = _compare(
                    label, torch.cat(got_a, 1), torch.cat(got_x, 1), tol)
    row["params"] = sum(p.numel() for p in model.parameters())
    del model, twin
    torch.cuda.empty_cache()
    return row


def _count_ties(log):
    """(tokens routed, tokens whose k-th and (k+1)-th scores are equal)."""
    tokens = sum(int(c["kth"].numel()) for c in log)
    ties = sum(int((c["kth"] == c["next"]).sum()) for c in log)
    return tokens, ties


def _zoo_full_one(arch, cfg, device):
    """Part (b) for one config at full width in bfloat16: every exit at
    B = 1 and 8 with the implied launches, the host/device split of a
    final-exit quantum, the router's ties in one B = 8 quantum, then
    prefill and greedy decode at B = 1."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.moe import record_routing
    from repro_torch.runtime.server import run_quantum, serve_lms

    cut = ZOO_BF16_CUTS.get(arch, {})
    cfg = dataclasses.replace(cfg, **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (mod,) = serve_lms({arch: cfg}, device=device, prompt_len=LM_PROMPT,
                       max_batch=LM_BATCHES[-1])
    build_s = time.perf_counter() - t0
    model = mod.values
    row = dict(cut=cut, build_seconds=build_s,
               params=sum(p.numel() for p in model.parameters()),
               quanta={}, launches={}, launches_implied={})
    for b in (1, LM_BATCHES[-1]):
        for e in range(cfg.num_exits):
            reset_launch_counts()
            idx, mx, lse = run_quantum(mod, e, b)
            got = {k: launch_counts[k] for k in
                   ("rmsnorm", "flash_attention", "exit_head",
                    "decode_attention")}
            want = dict(implied_launches(cfg, e), decode_attention=0)
            label = f"{arch}/exit{e}/B{b}"
            check(got == want, f"{label}: launches {got} != implied {want}")
            check(bool(torch.isfinite(mx).all() & torch.isfinite(lse).all())
                  and bool(((idx >= 0) & (idx < cfg.vocab_size)).all()),
                  f"{label}: exit decision not finite or off the vocab")
            for k, v in got.items():
                row["launches"][k] = row["launches"].get(k, 0) + v
                row["launches_implied"][k] = (
                    row["launches_implied"].get(k, 0) + want[k])
    row["breakdown"] = lm_breakdown([mod], emit_line=False, runs=3)
    if cfg.family in ("moe", "jamba"):
        with record_routing() as log:
            run_quantum(mod, cfg.num_exits - 1, LM_BATCHES[-1])
        tokens, ties = _count_ties(log)
        row["router"] = dict(calls=len(log), tokens=tokens, ties=ties)
    # prefill, then greedy decode at B = 1 at the final exit
    e = cfg.num_exits - 1
    batch = mod.data_fn(1)
    prompt = (batch["embeds"] if "embeds" in batch else batch["tokens"]
              ).shape[1]
    steps = ZOO_DECODE_STEPS
    with torch.inference_mode():
        logits, pref = model.prefill(batch, e)
        cache = _into_buffers(_init_cache(model, batch, 1, prompt + steps,
                                          e), pref, prompt)
        del pref
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        reset_launch_counts()
        walls, finite, tokens = [], [], [tok]
        for i in range(steps):
            if i == steps // 2:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    logits, cache = model.decode_step(tok, cache, e)
                    torch.cuda.synchronize()
                by_class, kcounts = _device_ms_by_class(prof)
            else:
                t1 = time.perf_counter()
                logits, cache = model.decode_step(tok, cache, e)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            finite.append(torch.isfinite(logits).all())
            tok = logits.argmax(-1)
            tokens.append(tok)
        counts = {k: launch_counts[k] for k in ("decode_attention",
                                                "rmsnorm")}
    want = _decode_launches_implied(cfg, e, steps)
    label = f"{arch}/decode"
    check(counts == want, f"{label}: launches {counts} != implied {want}")
    check(bool(torch.stack(finite).all()), f"{label}: logits not finite")
    gen_tokens = torch.cat(tokens, 1)
    check(bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()),
          f"{label}: a token outside the vocabulary")
    host_ms = float(np.median(walls)) * 1e3
    device_ms = sum(by_class.values())
    row["decode"] = dict(
        prompt=prompt, steps=steps, step_host_ms=host_ms,
        step_device_ms=device_ms, idle_share=1.0 - device_ms / host_ms,
        device_ms_by_class=by_class, kernels_by_class=kcounts,
        launches=counts, launches_implied=want)
    for k, v in counts.items():
        row["launches"][k] = row["launches"].get(k, 0) + v
        row["launches_implied"][k] = (row["launches_implied"].get(k, 0)
                                      + want[k])
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del mod, model, cache, logits
    torch.cuda.empty_cache()
    return row


def _zoo_live(device, horizon=HORIZON_S):
    """Part (c): RWKV6-1.6B, SeamlessM4T-large-v2, StarCoder2-7B and
    DeepSeek-MoE-16B served together in bfloat16 at full depth: the
    profile, then the EdgeServing scheduler (``cuda`` backend, float64
    numpy shadow) over Poisson 4:3:2:1 traffic that keeps the card 90%
    busy at the final exit and B = 8, SLO 50 ms, drained."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (
        SchedulerConfig,
        make_scheduler,
        poisson_arrivals,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime.server import (
        ServingEngine,
        measure_profile,
        serve_lms,
    )

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = serve_lms({a: get_config(a) for a in ZOO_LIVE}, device=device,
                       prompt_len=LM_PROMPT, max_batch=LM_BATCHES[-1])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = measure_profile(served, batch_sizes=LM_BATCHES,
                            exit_names=("exit0", "exit1", "exit2", "exit3"),
                            **ZOO_PROFILE)
    profile_s = time.perf_counter() - t0
    n = len(served)
    check(table.latency.shape == (n, 4, len(LM_BATCHES)), "zoo profile shape")
    split = np.array(ZOO_LIVE_SPLIT) / sum(ZOO_LIVE_SPLIT)
    per_request = table.latency[:, -1, -1] / LM_BATCHES[-1]
    total = LM_BUSY / float(np.sum(split * per_request))
    rates = total * split
    cfg = SchedulerConfig(slo=SLO, max_batch=LM_BATCHES[-1], backend="cuda",
                          device=device)
    sched = make_scheduler("edgeserving", table, cfg)
    rounds = record_rounds(sched)
    engine = ServingEngine(served, sched)
    engine.warmup()
    arrivals = poisson_arrivals(rates.tolist(), horizon, seed=0)
    reset_launch_counts()
    completions, span = engine.run(arrivals, horizon, drain=True)
    launches = {k: launch_counts[k] for k in KERNELS}
    m = engine.metrics(table, SLO, span)
    decisions = [r[1] for r in rounds if r[1] is not None]
    scored = [r for r in rounds if r[0].nonempty()]
    want = _expected_launches(served, decisions)
    out = dict(
        models=list(ZOO_LIVE), build_seconds=build_s,
        profile_seconds=profile_s,
        profile_ms={f"{table.model_names[i]}/{table.exit_names[e]}":
                    [float(x) for x in table.latency[i, e] * 1e3]
                    for i in range(n) for e in range(4)},
        total_req_s=total, per_model_req_s=rates.tolist(),
        arrivals=len(arrivals), completed=len(completions),
        dropped=engine.dropped, residual=m.residual_queue, span_s=span,
        p95_ms=m.p95_latency * 1e3, violation_ratio=m.violation_ratio,
        mean_exit_depth=m.mean_exit_depth, utilization=m.utilization,
        quanta=len(decisions), scoring_rounds=len(scored),
        launches=launches, launches_implied=want,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        per_model=[dict(model=pm.model, completed=pm.num_completed,
                        violation_ratio=pm.violation_ratio,
                        p95_ms=pm.p95_latency * 1e3)
                   for pm in m.per_model])
    check(len(completions) + engine.dropped + m.residual_queue
          == len(arrivals), "zoo arrivals not conserved")
    check(len(decisions) > 0, "no zoo quantum ran")
    check(launches["stability_score"] == len(scored),
          f"zoo stability launches {launches['stability_score']} != "
          f"scoring rounds {len(scored)}")
    for kernel, k_n in want.items():
        check(launches[kernel] == k_n, f"zoo {kernel} launches "
              f"{launches[kernel]} != {k_n} implied by the decisions")
    _, ties = shadow_check("lm_zoo_shadow", scored,
                           max_batch=LM_BATCHES[-1])
    out["float32_ties"] = ties
    del served, engine
    torch.cuda.empty_cache()
    return out, launches


def phase_lm_zoo(device):
    """The rest of the model zoo on the card: (a) every new family card
    against CPU in float32 at full width (depth and routed experts cut),
    block by block where tokens are routed; (b) the seven configs in
    bfloat16 at full width one at a time (two depth cuts); (c) four
    families served live together. Plus the kernels at the zoo's new
    shapes against their plain versions. Returns (the zoo's kernel
    launches, the kernel check's errors and timings)."""
    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(5)
    errs, timings = run_kernel_cases(_zoo_kernel_cases(), dev, gen)
    emit("lm_zoo_kernels", max_abs_err=errs, timings=timings,
         seconds=time.perf_counter() - t_phase)
    t0 = time.perf_counter()
    rows = {a: _zoo_f32_one(a, get_config(a), device) for a in ZOO_ARCHS}
    emit("lm_zoo_f32", tol=LM_TOL["float32"], tie_rtol=MOE_TIE_RTOL,
         batch=ZOO_F32["batch"], seq=ZOO_F32["seq"],
         prompt=ZOO_F32["prompt"], steps=ZOO_F32["steps"], rows=rows,
         cut={a: r["cut"] for a, r in rows.items()},
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches = {}
    full = {}
    for a in ZOO_ARCHS:
        full[a] = _zoo_full_one(a, get_config(a), device)
        for k, v in full[a]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    emit("lm_zoo_full", rows=full, cut={a: r["cut"] for a, r in full.items()},
         card=smi("name,power.limit"), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    live, live_launches = _zoo_live(device)
    emit("lm_zoo_live", **live, seconds=time.perf_counter() - t0)
    for k in ("rmsnorm", "flash_attention", "exit_head", "decode_attention",
              "stability_score"):
        launches[k] = launches.get(k, 0) + live_launches.get(k, 0)
    emit("lm_zoo_phase", seconds=time.perf_counter() - t_phase,
         launches=launches)
    return launches, dict(errs=errs, timings=timings)


# ---------------------------------------------------------------------------
# Phase 14: training (optimizers, the train step, checkpoints, the CLI loop)
# ---------------------------------------------------------------------------

# the trained cell: SmolLM-135M FULL in bfloat16 with float32 masters,
# through launch/train.py's loop; preempted after step PREEMPT - 1 (a save
# of step PREEMPT), then resumed with fresh model, optimizer and stream
TRAIN = dict(arch=LM_ARCHS[0], smoke=False, batch=8, seq=256, steps=30,
             every=10, preempt=20, lr=3e-3)
TRAIN_PROFILED_STEP = 25
TRAIN_CHECK = dict(batch=2, seq=32, lr=1e-4)  # the float32 card-vs-CPU step
RESUME_TOL = 1e-6   # examples/elastic_failover.py's bound
# rmsnorm's gradient per element: x^2 and its sum, dy * g * x and its sum,
# x^ = x * r, dy * g, x^ * c, the difference, its product with r, dy * x^
# and its sum into the gain's gradient
RMSNORM_BWD_OPS = 12


def train_implied_launches(cfg, grad_accum=1):
    """The kernels' launches one train step of ``cfg`` (a dense or GQA MoE
    family, no remat) implies: the forward as a final-exit quantum without
    the exit head (``implied_launches``) plus each exit's norm (``train_loss``
    takes every exit's logits), each norm (or q/k pair) and each attention
    call's backward two launches, all times ``grad_accum``."""
    check(cfg.remat == "none", f"{cfg.arch_id}: remat recomputes blocks")
    fwd = implied_launches(cfg, cfg.num_exits - 1)
    norms = fwd["rmsnorm"] + cfg.num_exits
    attn = fwd["flash_attention"]
    calls = {"rmsnorm": norms, "flash_attention": attn,
             "rmsnorm_bwd": 2 * norms, "flash_attention_bwd": 2 * attn}
    return {k: grad_accum * n for k, n in calls.items()}


def _train_kernel_cases(configs):
    """(kernel, label, shape) at the trained shapes of every LM (B = 8,
    S = 256: rmsnorm over B x S rows, the q/k pair over B x S x H and
    B x S x K rows, attention per layer), then the last model's attention
    at B = 1, S = 2048 (the same rmsnorm rows as B = 8, S = 256), at a
    ragged S = 77 and non-causal, and ragged rmsnorm rows; then the cases
    the trained LMs do not reach: attention at the `serve_multi_model`
    LMs' D = 16 and 32 (4 heads, 2 kv heads) and at G = 1 (DeepSeek-MoE's
    16 heads of D = 128), and rmsnorm rows of D = 100, which take the
    scalar layout in bfloat16 (200-byte rows)."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    cases = []
    for arch, cfg in configs.items():
        heads = (cfg.num_heads, cfg.num_kv_heads)
        dh = cfg.head_dim_
        cases.append(("rmsnorm_bwd", f"{arch}/residual", (b * s, cfg.d_model)))
        if cfg.qk_norm:
            cases.append(("rmsnorm_bwd", f"{arch}/qk_pair",
                          (b * s * cfg.num_heads, b * s * cfg.num_kv_heads,
                           dh)))
        cases.append(("flash_attention_bwd", f"{arch}/train",
                      (b, *heads, s, dh, True)))
    last = list(configs.values())[-1]
    heads, dh = (last.num_heads, last.num_kv_heads), last.head_dim_
    cases += [("flash_attention_bwd", "long_prompt_s2048",
               (1, *heads, 2048, dh, True)),
              ("flash_attention_bwd", "ragged_s77", (2, *heads, 77, dh, True)),
              ("flash_attention_bwd", "noncausal_s256",
               (2, *heads, s, dh, False)),
              ("rmsnorm_bwd", "ragged_t1000", (1000, 4096)),
              ("flash_attention_bwd", "multi_d16", (b, 4, 2, s, 16, True)),
              ("flash_attention_bwd", "multi_d32", (b, 4, 2, s, 32, True)),
              ("flash_attention_bwd", "g1_d128", (b, 16, 16, s, 128, True)),
              ("rmsnorm_bwd", "scalar_d100", (b * s, 100))]
    return cases


def _train_kernel_inputs(kernel, shape, dtype, device, gen):
    """rmsnorm: (x, g, dy) per tensor; attention: the model's [B, H, S, D]
    views of [B, S, H, D] q, k, v, the forward kernel's output, do, causal."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention

    def randn(*size, scale=1.0, shift=0.0):
        x = torch.randn(size, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale + shift).to(dtype)

    if kernel == "rmsnorm_bwd":
        *rows, d = shape
        return sum(((randn(t, d, scale=3.0), randn(d, scale=0.2, shift=1.0),
                     randn(t, d)) for t in rows), ())
    b, h, kh, s, d, causal = shape
    q = randn(b, s, h, d).transpose(1, 2)
    k, v = (randn(b, s, kh, d).transpose(1, 2) for _ in range(2))
    out = flash_attention(q, k, v, causal=causal)
    return q, k, v, out, randn(b, s, h, d).transpose(1, 2), causal


def _bwd_wrappers():
    """{kernel: (the backward wrapper, its plain version)}."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain,
    )
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd, rmsnorm_pair_bwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_plain

    def norm(*args):  # one tensor, or the q/k pair
        return (rmsnorm_bwd(*args) if len(args) == 3
                else rmsnorm_pair_bwd(*args))

    def norm_plain(*args):
        return (rmsnorm_bwd_plain(*args) if len(args) == 3 else
                (*rmsnorm_bwd_plain(*args[:3]), *rmsnorm_bwd_plain(*args[3:])))

    def attn(q, k, v, out, dout, causal):
        return flash_attention_bwd(q, k, v, out, dout, causal=causal)

    return {"rmsnorm_bwd": (norm, norm_plain),
            "flash_attention_bwd": (attn, flash_attention_bwd_plain)}


def _bwd_cost(kernel, shape, dtype):
    """(bytes, operations, rate) of one backward call: each input read once
    and each output written once; attention's five products (the scores
    again, dP, dV, dQ, dK) at 2 S^2 D a head each, halved when causal."""
    import torch

    el = torch.tensor([], dtype=dtype).element_size()
    if kernel == "rmsnorm_bwd":
        *rows, d = shape
        t = sum(rows)
        nbytes = 3 * t * d * el + len(rows) * (d * el + d * 4)
        return nbytes, RMSNORM_BWD_OPS * t * d, _rate(dtype, False)
    b, h, kh, s, d, causal = shape
    nbytes = (4 * b * h * s * d + 4 * b * kh * s * d) * el
    ops = 5 * 2 * b * h * s * s * d / (2 if causal else 1)
    return nbytes, ops, _rate(dtype, True)


def _bwd_library(kernel, args):
    """One PyTorch call giving the same gradient, timed as the yardstick
    (the port never calls it): autograd of ``F.rms_norm`` or of SDPA, on a
    graph built once, its forward run on the current stream; None for the
    q/k pair (no one call)."""
    import torch
    import torch.nn.functional as F

    if kernel == "rmsnorm_bwd":
        if len(args) != 3:
            return None
        x, g, dy = args
        xr, gr = (t.detach().requires_grad_(True) for t in (x, g))
        out = F.rms_norm(xr, (x.shape[-1],), weight=gr, eps=1e-6)
        return lambda: torch.autograd.grad(out, (xr, gr), dy,
                                           retain_graph=True)
    q, k, v, _, dout, causal = args
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal,
                                         enable_gqa=True)
    return lambda: torch.autograd.grad(out, (qr, kr, vr), dout,
                                       retain_graph=True)


def _grad_close(label, got, want, tol):
    """Max abs error of each of ``got`` against ``want``; raises where one
    exceeds tol * (1 + max|want|) (a gradient's scale-relative rule)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{label} not finite")
        e = float((g - w).abs().max()) if w.numel() else 0.0
        bound = tol * (1.0 + (float(w.abs().max()) if w.numel() else 0.0))
        check(e <= bound, f"{label}: max abs err {e} beyond {bound}")
        err = max(err, e)
    return err


def run_bwd_cases(cases, dev, gen):
    """Each backward case against its plain version in bfloat16 and
    float32, run twice and held bitwise, timed in both dtypes (with each
    case's wall time on the host, checks included). Returns
    ({kernel: {dtype: max abs err}}, {kernel: {label[/float32]: timing}})."""
    import torch

    from repro_torch.device import synchronize

    wrappers = _bwd_wrappers()
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in wrappers}
    timings = {k: {} for k in wrappers}
    for kernel, label, shape in cases:
        fn, plain = wrappers[kernel]
        for dname, dtype in dtypes.items():
            t0 = time.perf_counter()
            args = _train_kernel_inputs(kernel, shape, dtype, dev, gen)
            got = fn(*args)
            again = fn(*args)
            synchronize(dev)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{kernel} {label} {dname}: two runs differ")
            want = plain(*args)
            errs[kernel][dname] = max(errs[kernel][dname], _grad_close(
                f"{kernel} {label} {dname}", got, want, LM_TOL[dname]))
            nbytes, ops, rate = _bwd_cost(kernel, shape, dtype)
            bound, bound_by = _bound_ms(nbytes, ops, rate)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                lib = _bwd_library(kernel, args)
            key = label if dname == "bfloat16" else f"{label}/{dname}"
            timings[kernel][key] = dict(
                shape=list(shape), dtype=dname,
                ms=graph_ms(lambda: fn(*args), 10, per_graph=5),
                plain_ms=cuda_ms(lambda: plain(*args), 3, warmup=1),
                # replayed from a graph as ``ms`` is, so that neither
                # holds the host's launch cost
                library_ms=None if lib is None else graph_ms(
                    lib, 10, per_graph=5, stream=side),
                bound_ms=bound, bound_by=bound_by,
                seconds=time.perf_counter() - t0)  # the case's wall time
            del got, again, want, args, lib
    return errs, timings


def _train_check_batch(cfg, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_CHECK["batch"],
                                             TRAIN_CHECK["seq"] + 1),
                         generator=gen, dtype=torch.int64)
    return {"tokens": toks[:, :-1].to(torch.int32),
            "labels": toks[:, 1:].to(torch.int32)}


def _train_step_parts(model, batch, dev):
    """One float32 AdamW step of ``model`` on ``dev``, as ``train_step``
    runs it, with its parts left on ``dev``: (loss, {name: gradient},
    {name: new value}, the kernels' launches)."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import AdamW, clip_by_global_norm
    from repro_torch.runtime.trainer import make_grad_fn, master_values

    opt = AdamW(lr=TRAIN_CHECK["lr"])
    values = master_values(model)
    batch = {k: v.to(dev) for k, v in batch.items()}
    reset_launch_counts()
    loss, _, grads = make_grad_fn(model)(values, batch)
    clipped, _ = clip_by_global_norm(grads, 1.0)
    launches = dict(launch_counts)
    new, _ = opt.step(values, clipped, opt.init(values), 0)
    synchronize(dev)
    del values, clipped
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return float(loss), grads, new, launches


def _train_check_pair(label, model, batch, want_launches):
    """The step on the model's device (the kernels) against the same model
    moved to the CPU (the plain versions): loss at float32's 2e-3, every
    gradient by name and every updated value at 2e-3 * (1 + the leaf's
    largest), compared on the model's device; returns the errors."""
    import torch

    dev = next(model.parameters()).device
    card = _train_step_parts(model, batch, dev)
    host = _train_step_parts(model.to("cpu"), batch, torch.device("cpu"))
    tol = LM_TOL["float32"]
    check(abs(card[0] - host[0]) <= tol * abs(host[0]),
          f"{label}: loss {card[0]} on the card, {host[0]} on the CPU")
    check(set(card[1]) == set(host[1]), f"{label}: gradient names differ")
    grad_err = max(_grad_close(f"{label} grad {n}", [card[1][n]],
                               [host[1][n].to(dev)], tol) for n in host[1])
    value_err = max(_grad_close(f"{label} value {n}", [card[2][n]],
                                [host[2][n].to(dev)], tol) for n in host[2])
    if dev.type == "cuda":
        check(card[3] == want_launches,
              f"{label}: launches {card[3]}, implied {want_launches}")
    return dict(loss_card=card[0], loss_cpu=host[0],
                max_grad_err=grad_err, max_value_err=value_err,
                params=len(host[1]), launches=card[3])


def _train_f32_checks(configs, device):
    """One float32 train step card against CPU: SmolLM at full width and
    depth, the others at full width cut to 2 layers and one exit (phase 8's
    cut), and the FULL ResNet-50 (no kernel of the repo on its path)."""
    import dataclasses

    import torch

    from repro_torch.configs import FULL
    from repro_torch.data import cifar100_like
    from repro_torch.models import DecoderLM, EarlyExitResNet

    rows, cuts = {}, {}
    for i, (arch, cfg) in enumerate(configs.items()):
        if i == 0:
            cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        else:
            cfg32 = dataclasses.replace(cfg, num_layers=2, exits=(2,),
                                        dtype=torch.float32)
            cuts[arch] = "2 layers, one exit"
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(11 + i)
        model = DecoderLM(cfg32, generator=gen, device=device)
        rows[arch] = _train_check_pair(arch, model, _train_check_batch(
            cfg32, i), train_implied_launches(cfg32))
        rows[arch]["seconds"] = time.perf_counter() - t0
        del model
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = EarlyExitResNet(FULL["resnet50"], torch.Generator().manual_seed(
        3), device=device)
    imgs, labels = cifar100_like(TRAIN_CHECK["batch"], seed=4, device="cpu")
    rows["resnet50"] = _train_check_pair(
        "resnet50", model, {"images": imgs, "labels": labels}, {})
    rows["resnet50"]["seconds"] = time.perf_counter() - t0
    return rows, cuts


def _train_args(ckdir, resume=False, train=None):
    from repro_torch.launch.train import parser

    t = train or TRAIN
    argv = ["--arch", t["arch"], "--steps", str(t["steps"]),
            "--batch", str(t["batch"]), "--seq", str(t["seq"]),
            "--lr", str(t["lr"]), "--checkpoint-dir", ckdir,
            "--checkpoint-every", str(t["every"]),
            "--log-every", str(t["every"]), "--device", t["device"]]
    if t["smoke"]:
        argv.append("--smoke")
    if resume:
        argv.append("--resume")
    return parser().parse_args(argv)


def _train_loop(device, train, tmp):
    """The CLI loop three times: uninterrupted (every step synchronised and
    timed, its launches held to the implied count, one step profiled),
    preempted after step ``preempt`` - 1, and resumed from that save with a
    fresh model, optimizer and stream. Returns the phase's row and the
    loop's launches."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.device import synchronize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train as run_train
    from repro_torch.runtime.checkpoint import Checkpointer
    from repro_torch.runtime.fault_tolerance import PreemptionGuard

    dev = torch.device(device)
    cfg = get_config(train["arch"], smoke=train["smoke"])
    want = train_implied_launches(cfg)
    total = {}
    steps = []
    prof_box = {}

    def count(step):
        got = dict(launch_counts)
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        reset_launch_counts()
        if dev.type == "cuda":
            check(got == want, f"train step {step}: launches {got}, implied "
                  f"{want}")
        return got

    def on_timed(step, metrics):
        synchronize(dev)
        steps.append((step, time.perf_counter(), float(metrics["loss"])))
        count(step)
        if step == TRAIN_PROFILED_STEP - 1 and dev.type == "cuda":
            prof_box["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
            prof_box["prof"].__enter__()
            prof_box["t0"] = time.perf_counter()
        elif step == TRAIN_PROFILED_STEP and "prof" in prof_box:
            prof_box["wall_ms"] = (time.perf_counter() - prof_box["t0"]) * 1e3
            prof_box["prof"].__exit__(None, None, None)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    whole = run_train(_train_args(os.path.join(tmp, "whole"), train=train),
                      guard=PreemptionGuard(), on_step=on_timed)
    whole_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else None)
    check(whole["end_step"] == train["steps"], "the whole run stopped early")
    losses = [loss for _, _, loss in steps]
    check(losses[-1] < losses[0], f"train loss {losses[-1]} at the last "
          f"step is not below {losses[0]} at the first")
    walls = np.diff([t for _, t, _ in steps]) * 1e3  # steps 1..N-1, ms
    # the profiled step and the next (the profiler's start and stop) aside
    unprofiled = [w for s, w in zip(range(1, len(steps)), walls)
                  if s not in (TRAIN_PROFILED_STEP, TRAIN_PROFILED_STEP + 1)]
    step_ms = float(np.median(unprofiled))
    device_ms = by_class = kernels = None
    if "prof" in prof_box:
        by_class, kernels = _device_ms_by_class(prof_box["prof"])
        device_ms = sum(by_class.values())

    guard = PreemptionGuard()

    def on_cut(step, metrics):
        count(step)
        if step == train["preempt"] - 1:
            guard.request_stop()

    cut_dir = os.path.join(tmp, "cut")
    cut = run_train(_train_args(cut_dir, train=train), guard=guard,
                    on_step=on_cut)
    check(cut["end_step"] == train["preempt"],
          f"the preempted run ended at {cut['end_step']}")
    committed = Checkpointer(cut_dir).committed_steps()
    check(committed[-1] == train["preempt"],
          f"the preempted run's checkpoints {committed}")
    t0 = time.perf_counter()
    resumed = run_train(_train_args(cut_dir, resume=True, train=train),
                        guard=PreemptionGuard(),
                        on_step=lambda step, metrics: count(step))
    resume_s = time.perf_counter() - t0
    check(resumed["start_step"] == train["preempt"]
          and resumed["end_step"] == train["steps"],
          f"resumed {resumed['start_step']}..{resumed['end_step']}")
    diff = max(float((resumed["values"][k] - v).abs().max())
               for k, v in whole["values"].items())
    check(diff <= RESUME_TOL, f"resumed values differ from the whole run's "
          f"by {diff}, beyond {RESUME_TOL}")
    tokens = train["batch"] * train["seq"]
    row = dict(
        arch=cfg.arch_id, dtype=str(cfg.dtype).split(".")[-1],
        masters="float32", batch=train["batch"], seq=train["seq"],
        steps=train["steps"], lr=train["lr"], optimizer="AdamW",
        checkpoint_every=train["every"], preempted_at=train["preempt"],
        committed_when_preempted=committed, losses=losses,
        loss_first=losses[0], loss_last=losses[-1],
        resume_max_abs_diff=diff, resume_tol=RESUME_TOL,
        launches_per_step=want, launches=total,
        step_host_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
        profiled_step=TRAIN_PROFILED_STEP,
        profiled_step_wall_ms=prof_box.get("wall_ms"),
        step_device_ms=device_ms, device_ms_by_class=by_class,
        kernels_by_class=kernels,
        idle_share=(None if device_ms is None else 1.0 - device_ms / step_ms),
        peak_memory_gb=peak_gb, whole_run_s=whole_s, resumed_run_s=resume_s)
    return row, total


def phase_train(device, configs=None, train=None):
    """Training on the card: the two backward kernels against their plain
    versions at the trained shapes (bitwise twice, timed), one float32
    train step card against CPU for every parameter of SmolLM-135M (full),
    Phi-4-mini and Qwen3-8B (2 layers) and ResNet-50, then SmolLM-135M FULL
    trained in bfloat16 with float32 masters through launch/train.py's
    loop: preempted, resumed, launches as implied. Returns (the loop's
    launches, the kernel check's errors and timings)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    dev = torch.device(device)
    configs = configs or {arch: get_config(arch) for arch in LM_ARCHS}
    train = dict(TRAIN, device=device, **(train or {}))
    gen = torch.Generator(device=dev).manual_seed(13)
    errs, timings = run_bwd_cases(_train_kernel_cases(configs), dev, gen)
    emit("train_kernels", max_abs_err=errs, tol=LM_TOL,
         tol_rule="max|err| <= tol * (1 + max|plain|)", timings=timings,
         card=smi("name,power.limit"), seconds=time.perf_counter() - t_phase)
    t0 = time.perf_counter()
    rows, cuts = _train_f32_checks(configs, device)
    emit("train_f32", rows=rows, cut=cuts, tol=LM_TOL["float32"],
         batch=TRAIN_CHECK["batch"], seq=TRAIN_CHECK["seq"],
         seconds=time.perf_counter() - t0)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        row, launches = _train_loop(device, train, tmp)
    emit("train_loop", **row, card=smi("name,power.limit"),
         seconds=time.perf_counter() - t0)
    print(f"train: step host ms {row['step_host_ms']:.3f} against device ms "
          f"{row['step_device_ms']} (idle share {row['idle_share']}), "
          f"{row['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{row['peak_memory_gb']} GB", flush=True)
    emit("train_phase", seconds=time.perf_counter() - t_phase,
         launches=launches)
    return launches, dict(errs=errs, timings=timings)


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


def ptxas_budget(name):
    """nvcc's ``-Xptxas -v`` report of ``csrc/<name>.cu`` from this run's
    build, one entry a kernel: registers, spill stores and loads (bytes)
    and static shared memory (bytes; the kernels' dynamic shared memory is
    in their sources' headers). Empty where this process built nothing."""
    import re

    from repro_torch.kernels import build

    rows, entry = [], None
    for line in build.BUILD_LOG.get(name, {}).get("ptxas", "").splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"(2tc|3f32)?\d+(dq_kernel|dkv_kernel|"
                          r"rmsnorm_bwd_\w+?_kernel|rmsnorm_bwd_reduce)"
                          r"(I.*?EE)?", m.group(1))
            ns = {"2tc": "tc::", "3f32": "f32::"}.get(k.group(1), "")
            targs = k.group(3) or ""
            args = (["bf16"] if "__nv_bfloat16" in targs else
                    ["f32"] if targs.startswith("If") else [])
            args += re.findall(r"Li(\d+)E", targs)
            entry = {"kernel": ns + k.group(2)
                     + (f"<{', '.join(args)}>" if args else "")}
            rows.append(entry)
        elif entry is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            entry.update(spill_stores=int(st), spill_loads=int(ld))
        elif entry is not None and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            entry.update(registers=int(regs.group(1)),
                         smem_static=int(smem.group(1)) if smem else 0)
    return rows


def phase_audit(launched):
    """The launch audit on the card; launches nothing. For each of the
    seven kernels, at every envelope (the manifest's, and each set of plan
    arguments this run launched it with, ``launched``: what
    ``kernels/checks.py::recording`` gathered) and over the card-dependent
    range, the C ``<kernel>_plan`` of the built library must equal the
    Python ``launch_plan`` (LCH000) and the plan keep the launch limits
    (LCH001-LCH003); then every entry a plan launches is held to this
    build's ptxas report (LCH004: registers x threads, spills; LCH003 with
    the static shared memory). Fails on any finding that
    ``tools/lint_torch_baseline.json`` does not hold."""
    from repro_torch.analysis import launch_audit, manifest
    from repro_torch.analysis.baseline import Baseline
    from repro_torch.analysis.runner import BASELINE, layer_of
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    baseline = Baseline.load(str(ROOT.joinpath(*BASELINE)))
    baseline = Baseline([e for e in baseline.entries
                         if layer_of(e["rule"]) in ("launch", "card")])
    found, kernels = [], {}
    for spec in manifest.KERNEL_SPECS:
        ops = spec.ops()
        ran = [dict(k) for k in sorted(launched.get(spec.name, ()))]
        envs = manifest.dedup(spec.envelopes() + ran)
        points = manifest.device_points(spec)
        f_c, compared = launch_audit.c_plan_findings(spec, envs, points)
        f_py, _ = launch_audit.audit_kernel(spec, envs)
        # per entry, the launches with the most threads and the most
        # shared memory: the ones ptxas's numbers bound
        widest = {}
        for args in envs:
            for point in points:
                try:
                    plan = getattr(ops, spec.plan)(**args, **point)
                except ValueError:
                    continue
                for launch in plan:
                    threads = (launch.block[0] * launch.block[1]
                               * launch.block[2])
                    for key, value in (("threads", threads),
                                       ("smem", launch.smem)):
                        best = widest.get((launch.entry, key))
                        if best is None or value > best[0]:
                            widest[(launch.entry, key)] = (value, launch)
        f_ptx, rows = launch_audit.ptxas_findings(
            spec.name, [l for _, l in widest.values()],
            build.BUILD_LOG.get(spec.name, {}).get("ptxas", ""))
        new, accepted, _ = baseline.split(f_c + f_py + f_ptx)
        found += new
        kernels[spec.name] = {
            "envelopes": len(envs), "launched": len(ran),
            "plans_compared": compared, "findings": len(new),
            "baselined": len(accepted),
            "entries": {e: {k: r.get(k) for k in (
                "registers", "spill_stores", "spill_loads", "smem_static")}
                for e, r in sorted(rows.items())}}
    print(json.dumps({"audit": {
        "kernels": kernels,
        "envelopes": sum(k["envelopes"] for k in kernels.values()),
        "findings": len(found),
        "baselined": sum(k["baselined"] for k in kernels.values()),
        "seconds": time.perf_counter() - t0}}), flush=True)
    if found:
        raise SystemExit("audit: " + "; ".join(f.format() for f in found))
    return kernels


BWD_KERNEL_ROWS = {
    # kernel: (source, what it replaces, the main timed case)
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm_bwd.cu",
                    "src/repro/models/common.py:135",
                    f"{LM_ARCHS[0]}/residual"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:52",
                            f"{LM_ARCHS[0]}/train"),
}


def kernel_summary(kernel, resnet_launches, sim_launches, fleet_launches,
                   lm_kernels, lm_launches, decode_launches, multi_launches,
                   multi_timings, zoo_launches, zoo_kernels, train_launches,
                   train_kernels, cost_launches):
    """One entry per kernel of the port's paths, with every key of the
    contract; the stability score's launches are the three serving runs',
    the simulated cells', the fleet cells' and the cost phase's
    simulations, and the LM kernels' those of
    the LM serve, the decode phase, the serve_multi_model run (whose timed
    shapes join each row's ``cases``) and the training loop. The backward
    kernels replace no TPU kernel: ``replaces`` names the jnp form whose
    gradient the reference takes with XLA's autodiff."""
    t3 = kernel["timings"]["m3"]
    t256 = kernel["timings"]["m256"]
    rows = [{
        "name": "stability_score",
        "route": "cuda",
        "source": "src/repro_torch/csrc/stability_score.cu",
        "replaces": "src/repro/kernels/stability_score/kernel.py:35",
        "launches": (resnet_launches + sim_launches + fleet_launches
                     + lm_launches["stability_score"]
                     + zoo_launches["stability_score"]
                     + multi_launches["stability_score"] + cost_launches),
        "launches_resnet_serve": resnet_launches,
        "launches_sim": sim_launches,
        "launches_fleet": fleet_launches,
        "launches_lm_serve": lm_launches["stability_score"],
        "launches_lm_zoo": zoo_launches["stability_score"],
        "launches_lm_multi": multi_launches["stability_score"],
        "launches_cost": cost_launches,
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
                 "lm_decode": decode_launches.get(name, 0),
                 "lm_zoo": zoo_launches.get(name, 0),
                 "lm_multi": multi_launches.get(name, 0),
                 "train": train_launches.get(name, 0)}
        zoo_errs = zoo_kernels["errs"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            **{f"launches_{p}": n for p, n in paths.items()},
            "max_abs_err": max(lm_kernels["errs"][name]["float32"],
                               zoo_errs["float32"]),
            "max_abs_err_bf16": max(lm_kernels["errs"][name]["bfloat16"],
                                    zoo_errs["bfloat16"]),
            "case": main_case, "shape": t["shape"], "dtype": t["dtype"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{k: t[k] for k in ("path", "cold_ms") if k in t},
            "cases": {**timings, **zoo_kernels["timings"][name],
                      **multi_timings.get(name, {})},
        })
        f32 = timings.get(f"{main_case}/float32")
        if f32 is not None:
            rows[-1].update({f"{k}_f32": f32[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    for name, (source, replaces, main_case) in BWD_KERNEL_ROWS.items():
        timings = train_kernels["timings"][name]
        t, f32 = timings[main_case], timings[f"{main_case}/float32"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "replaces_note": "no TPU kernel: the gradient XLA's autodiff "
                             "takes of this jnp form in train_loss",
            "launches": train_launches.get(name, 0),
            "launches_train": train_launches.get(name, 0),
            "max_abs_err": train_kernels["errs"][name]["float32"],
            "max_abs_err_bf16": train_kernels["errs"][name]["bfloat16"],
            "tol_rule": "max|err| <= tol * (1 + max|plain|)",
            "case": main_case, "shape": t["shape"], "dtype": t["dtype"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{f"{k}_f32": f32[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": timings,
            "ptxas": ptxas_budget(name),
        })
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
    from repro_torch.kernels import checks

    lm_configs = {arch: get_config(arch) for arch in LM_ARCHS}
    with checks.recording() as launched:
        phase_device_and_build()
        kernel = phase_kernel("cuda")
        lm_kernels = phase_lm_kernels(lm_configs, "cuda")
        served = phase_models(FULL, "cuda")
        resnet_launches = phase_serving(served, "cuda")
        del served
        torch.cuda.empty_cache()
        sim_launches = phase_sim("cuda")
        fleet_launches = phase_fleet("cuda")
        phase_scan("cuda")
        phase_lm_models(lm_configs, "cuda")
        phase_lm_decode_models(lm_configs, "cuda")
        lm_launches, served, lm_table = phase_lm_serving(lm_configs, "cuda")
        decode_launches = phase_lm_decode(served, "cuda")
        del served
        torch.cuda.empty_cache()
        cost_launches = phase_cost("cuda", lm_configs, lm_table)
        zoo_launches, zoo_kernels = phase_lm_zoo("cuda")
        multi_launches, multi_timings = phase_lm_multi("cuda")
        torch.cuda.empty_cache()
        train_launches, train_kernels = phase_train("cuda")
    phase_audit(launched)
    print(json.dumps({"kernels": kernel_summary(
        kernel, resnet_launches, sim_launches, fleet_launches, lm_kernels,
        lm_launches, decode_launches, multi_launches, multi_timings,
        zoo_launches, zoo_kernels, train_launches, train_kernels,
        cost_launches)}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
