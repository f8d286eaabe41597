"""The port's precision and launch manifest: every contract the analyzers
enforce, in one declarative place (the counterpart of
``src/repro/analysis/manifest.py``; docs/static-analysis-torch.md renders
its justifications).

* **Path contracts** (the AST layer, :mod:`~repro_torch.analysis.detlint`):
  ``FLOAT64_PATHS`` (DET005's scope), ``ENGINE_MODULES`` (DET002's), and
  the documented exceptions ``TIMING_ALLOWLIST`` and
  ``FLOAT32_ALLOWANCES``.
* **Traced artifacts** (the graph layer,
  :mod:`~repro_torch.analysis.graph_audit`): ``PRECISION_ARTIFACTS`` names
  the functions traced to aten graphs with their dtype contract; a
  ``float32`` contract is a declared tier whose ``rtol`` the tolerance test
  (``tests/test_torch_graph_audit.py``) holds against the float64 numpy
  backend. ``RECOMPILE_GUARDS``: sweeps that must not grow the port's graph
  caches (the ``lru_cache`` of step objects and backends).
* **Kernel envelopes** (the launch layer,
  :mod:`~repro_torch.analysis.launch_audit`): ``KERNEL_SPECS`` gives each of
  the seven ``csrc/*.cu`` kernels its plan (``launch_plan`` in its ops
  module, mirrored by ``<kernel>_plan`` in the source) and the shapes to
  audit it at.

Builders import their targets lazily, so the AST layer stays light.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Allowance", "ArtifactSpec", "RecompileGuard", "KernelSpec",
    "ENGINE_MODULES", "TIMING_ALLOWLIST", "FLOAT64_PATHS",
    "FLOAT32_ALLOWANCES", "PRECISION_ARTIFACTS", "RECOMPILE_GUARDS",
    "KERNEL_SPECS",
]


@dataclasses.dataclass(frozen=True)
class Allowance:
    """A documented exception to a path contract, scoped to a qualname."""

    path: str           # repo-relative file
    scope: str          # enclosing qualname (prefix match)
    justification: str  # rendered in docs; required


@dataclasses.dataclass(frozen=True)
class ArtifactSpec:
    """A function the graph auditor traces with ``make_fx`` under fake
    tensors: ``build()`` returns ``(fn, args)``. ``rtol`` is the declared
    error bound of a ``float32``-contract artifact against the float64
    reference (enforced by the tolerance test)."""

    name: str
    dtype_contract: str                     # "float64" | "float32"
    build: Callable[[], Tuple[Any, tuple]]
    rtol: Optional[float] = None
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class RecompileGuard:
    """A graph cache that a value sweep must not grow: ``build()`` returns
    ``(cache, calls)``, ``cache`` an ``lru_cache``-wrapped function (its
    ``cache_info()``) and ``calls`` zero-argument callables. The first
    call primes the cache; the others must add no entry."""

    name: str
    build: Callable[[], Tuple[Any, List[Callable[[], Any]]]]
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ``csrc/<name>.cu`` kernel for the launch audit: its ops module,
    the names there of its entries, plan, C arguments and C argument types,
    the plan arguments that depend on the card (name -> inclusive range,
    audited over all of it), and its envelopes (dicts of plan arguments)."""

    name: str
    module: str
    entries: str = "ENTRIES"
    plan: str = "launch_plan"
    c_args: str = "plan_c_args"
    argtypes: str = "PLAN_ARGTYPES"
    device_range: str = ""
    envelopes: Callable[[], List[dict]] = lambda: []
    notes: str = ""

    def ops(self):
        import importlib

        return importlib.import_module(self.module)


# ---------------------------------------------------------------------------
# Path contracts (the AST layer's scope)
# ---------------------------------------------------------------------------

# Engines evolve simulated time (the reference's list, in the port).
ENGINE_MODULES: Tuple[str, ...] = (
    "src/repro_torch/core/simulator.py",
    "src/repro_torch/core/simfast.py",
    "src/repro_torch/core/cluster.py",
    "src/repro_torch/core/clusterfast.py",
    "src/repro_torch/core/seedband.py",
    "src/repro_torch/core/telemetry.py",
)

TIMING_ALLOWLIST: Tuple[Allowance, ...] = (
    Allowance(
        "src/repro_torch/core/simfast.py", "_timed",
        "_timed only adds host wall seconds into simfast.split_seconds, "
        "which chip_smoke.py's scan phase prints as a host split; "
        "split_seconds feeds no result: no decision, clock, metric or "
        "trace of the scan tiers reads it, so the runs stay bitwise "
        "whatever the clock says."),
)

# The scheduling arithmetic under core/ is float64, as the reference's
# (x64) is: the scan tiers' bitwise equality with the Python engines and
# the goldens rest on it. The stability-score wrapper is in scope too: it
# is the sanctioned float64 -> float32 boundary, and every downcast there
# carries an inline suppression pointing at its tolerance bound.
FLOAT64_PATHS: Tuple[str, ...] = (
    "src/repro_torch/core/",
    "src/repro_torch/kernels/stability_score/ops.py",
)

FLOAT32_ALLOWANCES: Tuple[Allowance, ...] = (
    Allowance(
        "src/repro_torch/core/scoring.py", "TorchScoringBackend.score",
        "the torch backend is the declared float32 tier (the reference's "
        "jnp backend): inputs are downcast at this boundary only, decisions "
        "are held equal to the float64 backend's up to float32 ties "
        "(tests/test_torch_scoring.py) and the score error by the "
        "tolerance test (tests/test_torch_graph_audit.py)."),
    Allowance(
        "src/repro_torch/core/scoring.py", "CudaScoringBackend",
        "the cuda backend packs float32 host and device buffers for the "
        "stability-score kernel (csrc/stability_score.cu): the same "
        "declared boundary and tolerance bound as the torch backend."),
    Allowance(
        "src/repro_torch/kernels/stability_score/ops.py", "stability_scores",
        "the stability-score kernel's wrapper is the kernel's float32 tier: "
        "it takes float32 w, mask and tau, downcasts the latencies and "
        "returns float32 scores, the one sanctioned float64 -> float32 "
        "boundary of the scheduler's scoring, held to the float64 numpy "
        "backend by the tolerance test (tests/test_torch_graph_audit.py)."),
)


# ---------------------------------------------------------------------------
# The graph layer: traced artifacts
# ---------------------------------------------------------------------------


def _scan_key(factored: bool):
    from repro_torch.core.simfast import _StaticKey

    # tiny but exercising every branch: 2 models, 2 exits, a greedy
    # single-rung ladder for caps 0..2, the margin outputs on
    return _StaticKey(
        num_models=2, num_exits=2, max_queue=4, pad_len=8, chunk_steps=4,
        max_batch=2, ladder=((0,), (1,), (2,)), allowed=(True, True),
        fallback_exit=0, clip=10.0, factored=factored, emit_aux=True)


def step_artifact(steps):
    """``(fn, args)`` tracing one ``steps._step(0)`` of a scan step object
    (``core/simfast.py::_GraphedSteps``): every tensor the object holds is
    an argument, so the graph has the step's whole arithmetic."""
    import torch

    names = [n for n, v in vars(steps).items()
             if isinstance(v, torch.Tensor)]
    orig = {n: getattr(steps, n) for n in names}
    tuples = {n: v for n, v in vars(steps).items()
              if isinstance(v, tuple) and v
              and all(isinstance(t, torch.Tensor) for t in v)}

    def step(*vals):
        new = dict(zip(names, vals))
        by_id = {id(orig[n]): new[n] for n in names}
        try:
            for n, v in new.items():
                setattr(steps, n, v)
            for n, tup in tuples.items():
                setattr(steps, n, tuple(by_id.get(id(t), t) for t in tup))
            type(steps)._step(steps, 0)
        finally:
            for n, v in orig.items():
                setattr(steps, n, v)
            for n, tup in tuples.items():
                setattr(steps, n, tup)
        return tuple(new[n] for n in names)

    step.__wrapped__ = type(steps)._step
    return step, tuple(orig[n] for n in names)


def _build_scan_step(factored: bool):
    import torch

    from repro_torch.core.simfast import _ScanSteps

    return step_artifact(_ScanSteps(_scan_key(factored), 2,
                                    torch.device("cpu")))


def _cluster_key():
    from repro_torch.core.clusterfast import _ClusterKey

    # 2 devices, 2 models, 2 exits, the least-loaded dispatcher, a
    # 2-arrival burst, a greedy single-rung ladder for caps 0..2
    return _ClusterKey(
        num_devices=2, num_models=2, num_exits=2, max_queue=4, pad_len=8,
        chunk_steps=4, burst=2, max_batch=2, ladder=((0,), (1,), (2,)),
        allowed=(True, True), fallback_exit=0, clip=10.0, factored=True,
        dispatcher="least-loaded")


def _build_cluster_step():
    import torch

    from repro_torch.core.clusterfast import _ClusterSteps

    return step_artifact(_ClusterSteps(_cluster_key(), 2,
                                       torch.device("cpu")))


def _lattice_args(dtype):
    import torch

    m, q, n = 3, 8, 6
    gen = torch.Generator().manual_seed(0)
    w = torch.rand((m, q), generator=gen, dtype=torch.float64) * 0.1
    return (w.to(dtype), torch.ones((m, q), dtype=dtype),
            (torch.rand(n, generator=gen, dtype=torch.float64)
             * 0.02).to(dtype),
            torch.randint(1, 4, (n,), generator=gen),
            torch.randint(0, m, (n,), generator=gen), 0.05, 10.0)


def _build_lattice(dtype_name: str):
    import torch

    from repro_torch.core.urgency import lattice_stability_scores

    return lattice_stability_scores, _lattice_args(getattr(torch,
                                                           dtype_name))


def _build_stability_plain():
    import torch

    from repro_torch.kernels.stability_score.ref import (
        stability_scores_plain,
    )

    w, mask, lat, bat, cq, tau, clip = _lattice_args(torch.float32)

    def plain(w, mask, lat, bat, cq):
        return stability_scores_plain(w, mask, lat, bat.to(torch.int32),
                                      cq.to(torch.int32), tau=tau,
                                      clip=clip)

    plain.__wrapped__ = stability_scores_plain
    return plain, (w, mask, lat, bat, cq)


PRECISION_ARTIFACTS: Tuple[ArtifactSpec, ...] = (
    ArtifactSpec(
        name="urgency.lattice_stability_scores",
        dtype_contract="float64", build=lambda: _build_lattice("float64"),
        notes="Eq. 4-7 reference scoring, the oracle the backends and the "
              "engines are held to; any float32 here poisons what follows."),
    ArtifactSpec(
        name="simfast.scan_step[factored]", dtype_contract="float64",
        build=lambda: _build_scan_step(True),
        notes="one scan round (factored-exponential scoring); bitwise "
              "equal decisions and metrics with the Python engine need "
              "pure float64."),
    ArtifactSpec(
        name="simfast.scan_step[direct]", dtype_contract="float64",
        build=lambda: _build_scan_step(False),
        notes="one scan round on the direct Eq. 3 path."),
    ArtifactSpec(
        name="clusterfast.scan_step[least-loaded]",
        dtype_contract="float64", build=_build_cluster_step,
        notes="one cluster step (arrival burst, device round, dispatcher "
              "fold over the [G, M, Q] rings); the one-ulp idle poke and "
              "the drain-table folds die in float32."),
    ArtifactSpec(
        name="scoring.torch_backend", dtype_contract="float32",
        build=lambda: _build_lattice("float32"), rtol=2e-4,
        notes="the torch backend's arithmetic: lattice_stability_scores "
              "on the float32 tensors TorchScoringBackend.score makes "
              "(the reference's scoring.jnp_backend)."),
    ArtifactSpec(
        name="stability_score.plain", dtype_contract="float32",
        build=_build_stability_plain, rtol=2e-4,
        notes="the kernel's plain version (kernels/stability_score/"
              "ref.py), float32 as the kernel (the reference's "
              "stability_score.kernel); the CUDA kernel is held to it "
              "on the card."),
)


# ---------------------------------------------------------------------------
# The graph layer: recompile guards
# ---------------------------------------------------------------------------


def _arrivals(horizon: float = 0.3):
    from repro_torch.core.traffic import paper_rate_vector, poisson_arrivals

    return poisson_arrivals(paper_rate_vector(60.0), horizon, seed=0)


def _guard_scan():
    from repro_torch.core.profile import ProfileTable
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.simfast import _scan_steps, simulate_scan

    table = ProfileTable.paper_rtx3080().with_batch_saturation(4)
    lane = _arrivals()

    def run(tau, cap):
        sched = make_scheduler("edgeserving", table, SchedulerConfig(slo=tau))
        return lambda: simulate_scan(sched, table, lane, 0.3, drain_cap=cap,
                                     device="cpu")

    return _scan_steps, [run(tau, cap) for tau in (0.05, 0.08, 0.12)
                         for cap in (600.0, 300.0)]


def _guard_cluster():
    from repro_torch.core.cluster import make_fleet
    from repro_torch.core.clusterfast import (
        _cluster_steps,
        simulate_cluster_scan,
    )
    from repro_torch.core.profile import ProfileTable
    from repro_torch.core.scheduler import SchedulerConfig

    table = ProfileTable.paper_rtx3080().with_batch_saturation(4)
    fleet = make_fleet("homogeneous", 2, table)
    lane = _arrivals()

    def run(tau, cap):
        return lambda: simulate_cluster_scan(
            fleet, lane, 0.3, config=SchedulerConfig(slo=tau),
            dispatcher="least-loaded", drain_cap=cap, device="cpu")

    return _cluster_steps, [run(tau, cap) for tau in (0.05, 0.08)
                            for cap in (600.0, 300.0)]


def _guard_backend():
    import numpy as np

    from repro_torch.core.scoring import make_scoring_backend

    rng = np.random.default_rng(42)
    m, q, n = 3, 8, 6
    w = rng.uniform(0, 0.1, (m, q))
    mask = np.ones((m, q))
    lat = rng.uniform(1e-3, 2e-2, n)
    bat = rng.integers(1, 4, n)
    cq = rng.integers(0, m, n)

    def run(name, tau, clip):
        return lambda: make_scoring_backend(name, "cpu").score(
            w, mask, lat, bat, cq, tau, clip)

    return make_scoring_backend, [run("torch", tau, clip)
                                  for tau in (0.02, 0.05, 0.08)
                                  for clip in (5.0, 10.0)]


RECOMPILE_GUARDS: Tuple[RecompileGuard, ...] = (
    RecompileGuard(
        name="simfast._scan_steps[tau/drain-cap sweep]", build=_guard_scan,
        notes="the step objects are keyed by _StaticKey only; the SLO "
              "and the drain cap are loaded values (clip is part of the "
              "key, as in the reference)."),
    RecompileGuard(
        name="clusterfast._cluster_steps[tau/drain-cap sweep]",
        build=_guard_cluster,
        notes="the cluster step objects are keyed by _ClusterKey only."),
    RecompileGuard(
        name="scoring.make_scoring_backend[tau/clip sweep]",
        build=_guard_backend,
        notes="one backend instance a (name, device), whatever the SLO "
              "and clip: the cuda backend's buffers are reused."),
)


# ---------------------------------------------------------------------------
# The launch layer: kernel envelopes
# ---------------------------------------------------------------------------

def _serve_shapes():
    """Per-device (B, S, config) of the serve cells of configs/shapes.py
    on the (16, 16) mesh, every config at full width: the batch split over
    "data" (16), heads and vocab over "model" (16) where they divide."""
    from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config

    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name in ("prefill_32k", "decode_32k", "long_500k"):
            spec = SHAPES[name]
            if not applicable(cfg, name):
                continue
            out.append((max(spec.global_batch // 16, 1), spec.seq_len,
                        spec.kind, cfg))
    return out


def _split(n: int, ways: int = 16) -> int:
    return n // ways if n % ways == 0 else n


def _heads(cfg):
    """(query heads, kv heads, head dim) a device runs attention with."""
    h = _split(cfg.num_heads)
    kh = cfg.num_kv_heads or cfg.num_heads
    kh = _split(kh) if kh % 16 == 0 else max(kh * h // cfg.num_heads, 1)
    if h % kh:
        kh = 1
    return h, kh, cfg.head_dim


def _envelopes_attention(bwd: bool):
    out = [dict(b=1, h=4, kh=2, s=512, d=64, dtype=t) for t in (0, 1)]
    for b, s, kind, cfg in _serve_shapes():
        if cfg.family not in ("dense", "moe", "jamba") or cfg.mla:
            continue
        h, kh, d = _heads(cfg)
        if d not in (16, 32, 64, 128):
            continue
        if kind == "prefill" or bwd:
            out.append(dict(b=b, h=h, kh=kh, s=s if not bwd else 4096, d=d,
                            dtype=1))
    return out


def _envelopes_decode():
    out = [dict(b=2, h=4, kh=2, s=1024, d=64, dtype=t) for t in (0, 1)]
    for b, s, kind, cfg in _serve_shapes():
        if kind != "decode" or cfg.mla or cfg.family not in ("dense", "moe",
                                                              "jamba"):
            continue
        h, kh, d = _heads(cfg)
        if d in (16, 32, 64, 128):
            out.append(dict(b=b, h=h, kh=kh, s=s, d=d, dtype=1))
    return out


def _envelopes_exit_head():
    out = [dict(t=256, d=512, v=4096, dtype=t, aligned=1) for t in (0, 1)]
    for b, s, kind, cfg in _serve_shapes():
        v = _split(cfg.vocab_size)
        out.append(dict(t=b, d=cfg.d_model, v=v, dtype=1,
                        aligned=int(v * 2 % 16 == 0)))
    return out


def _envelopes_rmsnorm():
    out = [dict(t_a=512, t_b=0, d=2048, dtype=t, aligned=1) for t in (0, 1)]
    for b, s, kind, cfg in _serve_shapes():
        rows = b * (s if kind == "prefill" else 1)
        out.append(dict(t_a=rows, t_b=0, d=cfg.d_model, dtype=1, aligned=1))
        if cfg.family == "rwkv":   # the per-head group norm
            out.append(dict(t_a=rows * _split(cfg.num_heads), t_b=0,
                            d=cfg.head_dim, dtype=1, aligned=1))
    return out


def _envelopes_rmsnorm_bwd():
    out = [dict(t_a=512, t_b=0, d=2048, dtype=t, aligned=1, two=0)
           for t in (0, 1)]
    out += [dict(t_a=16 * 4096, t_b=0, d=d, dtype=1, aligned=1, two=0)
            for d in (576, 2048, 3072, 4096)]
    return out


def _envelopes_stability():
    out = [dict(n=12, m=4, q=16)]
    # the served lattices: 3 models x 3 exits x batch 1..32 over queues of
    # up to 256 and 4096 tasks (the warp and the tile kernels)
    out += [dict(n=n, m=3, q=q) for n in (3, 288) for q in (64, 256, 4096)]
    return out


KERNEL_SPECS: Tuple[KernelSpec, ...] = (
    KernelSpec(
        name="stability_score",
        module="repro_torch.kernels.stability_score.ops",
        envelopes=_envelopes_stability,
        notes="the scheduler's scoring kernel: a warp a candidate over few "
              "tasks, K candidates a 1024-thread block over many."),
    KernelSpec(
        name="rmsnorm", module="repro_torch.kernels.rmsnorm.ops",
        envelopes=_envelopes_rmsnorm,
        notes="row layouts by D; rows of every prefill token at 32k."),
    KernelSpec(
        name="rmsnorm_bwd", module="repro_torch.kernels.rmsnorm.ops",
        entries="BWD_ENTRIES", plan="bwd_launch_plan",
        c_args="bwd_plan_c_args", argtypes="BWD_PLAN_ARGTYPES",
        envelopes=_envelopes_rmsnorm_bwd,
        notes="the train step's rows (16 sequences of 4096 a device) at "
              "the zoo's widths, and the reference's rmsnorm envelope."),
    KernelSpec(
        name="flash_attention",
        module="repro_torch.kernels.flash_attention.ops",
        envelopes=lambda: _envelopes_attention(False),
        notes="the reference's (1, 4 heads / 2 kv, 512, 64) and every "
              "served prefill at 32k a device."),
    KernelSpec(
        name="flash_attention_bwd",
        module="repro_torch.kernels.flash_attention.ops",
        entries="BWD_ENTRIES", plan="bwd_launch_plan",
        envelopes=lambda: _envelopes_attention(True),
        notes="the train shape (S = 4096) at the served heads."),
    KernelSpec(
        name="decode_attention",
        module="repro_torch.kernels.decode_attention.ops",
        envelopes=_envelopes_decode,
        notes="split-K decode over a 32k (and, for Jamba, 512k) cache."),
    KernelSpec(
        name="exit_head", module="repro_torch.kernels.exit_head.ops",
        device_range="DEVICE_RANGE", envelopes=_envelopes_exit_head,
        notes="the persistent grid bounded over 1-132 SMs and 1-8 "
              "resident blocks an SM."),
)


def kernel_spec(name: str) -> KernelSpec:
    for spec in KERNEL_SPECS:
        if spec.name == name:
            return spec
    raise KeyError(name)


def device_points(spec: KernelSpec) -> List[Dict[str, int]]:
    """Every combination of the card-dependent plan arguments in their
    ranges ([{}] for a kernel whose plan depends on none)."""
    if not spec.device_range:
        return [{}]
    ranges: Dict[str, Tuple[int, int]] = getattr(spec.ops(),
                                                 spec.device_range)
    points: List[Dict[str, int]] = [{}]
    for name, (lo, hi) in ranges.items():
        points = [dict(p, **{name: v}) for p in points
                  for v in range(lo, hi + 1)]
    return points


def dedup(envelopes: Sequence[dict]) -> List[dict]:
    seen, out = set(), []
    for e in envelopes:
        key = tuple(sorted(e.items()))
        if key not in seen:
            seen.add(key)
            out.append(dict(e))
    return out
