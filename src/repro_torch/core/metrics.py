"""Serving metrics (paper Sec. VI): SLO violation ratio, tail latency,
exit-depth distribution, and lookup-based effective accuracy."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.profile import ProfileTable
from repro_torch.core.request import Completion


@dataclasses.dataclass(frozen=True)
class ModelMetrics:
    """Per-model (per-queue) breakdown of a serving window.

    Bursty workloads concentrate damage on individual queues; the aggregate
    violation ratio hides which queue absorbed it. One entry per model index
    in ``ServingMetrics.per_model`` makes it visible.
    """

    model: int
    num_completed: int
    violation_ratio: float
    p50_latency: float
    p95_latency: float
    mean_queueing: float
    mean_exit_depth: float


@dataclasses.dataclass(frozen=True)
class ServingMetrics:
    """Aggregate results over a serving window (post-warmup completions)."""

    num_completed: int
    violation_ratio: float          # Eq. 2
    p50_latency: float
    p95_latency: float
    p99_latency: float
    mean_latency: float
    mean_queueing: float
    mean_exit_depth: float          # 1..E (paper Fig. 5)
    mean_accuracy: float            # Table-I-lookup average (paper Sec. VI-C)
    throughput: float               # completed req/s over the measured span
    utilization: float              # accelerator busy fraction
    mean_batch: float
    residual_queue: int             # tasks still queued at the end (overload)
    dropped: int = 0                # shed requests (Symphony); count as violations
    warmup_used: int = 0            # completions actually excluded (post-clamp)
    per_model: "tuple[ModelMetrics, ...]" = ()
    per_device: tuple = ()  # cluster runs only (the cluster tier is not ported yet)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def summarize(
    completions: Sequence[Completion],
    table: ProfileTable,
    slo: float,
    warmup_tasks: int = 100,
    busy_time: float = 0.0,
    span: float = 0.0,
    residual_queue: int = 0,
    model_map: Optional[Sequence[int]] = None,
    dropped: int = 0,
) -> ServingMetrics:
    """Aggregate a completion log.

    Args:
      completions: completion records ordered by finish time.
      table:       profile table used for accuracy lookup.
      slo:         deadline tau in seconds (fallback when a completion has no
                   per-request ``deadline`` of its own).
      warmup_tasks: paper excludes the first 100 completed tasks. For runs
                   shorter than the warmup this is clamped to half the
                   completion count, so a short run reports honest non-zero
                   metrics instead of silently collapsing to all zeros; the
                   exclusion actually applied is surfaced as ``warmup_used``.
      busy_time:   accelerator-occupied seconds (for utilisation).
      span:        wall-clock span of the experiment in seconds.
      model_map:   optional mapping completion.model -> profile row (used by
                   deployment-mix studies where queue i serves table row j).
      dropped:     shed requests; counted as violations (a dropped request
                   certainly misses its deadline).
    """
    completions = list(completions)
    return summarize_arrays(
        models=np.array([c.model for c in completions], dtype=np.int64),
        exits=np.array([c.exit_idx for c in completions], dtype=np.int64),
        batches=np.array([c.batch_size for c in completions], dtype=np.int64),
        latencies=np.array([c.total_latency for c in completions]),
        queueings=np.array([c.queueing for c in completions]),
        taus=np.array(
            [slo if c.deadline is None else c.deadline for c in completions]
        ),
        table=table,
        warmup_tasks=warmup_tasks,
        busy_time=busy_time,
        span=span,
        residual_queue=residual_queue,
        model_map=model_map,
        dropped=dropped,
    )


def summarize_arrays(
    models: np.ndarray,
    exits: np.ndarray,
    batches: np.ndarray,
    latencies: np.ndarray,
    queueings: np.ndarray,
    taus: np.ndarray,
    table: ProfileTable,
    warmup_tasks: int = 100,
    busy_time: float = 0.0,
    span: float = 0.0,
    residual_queue: int = 0,
    model_map: Optional[Sequence[int]] = None,
    dropped: int = 0,
) -> ServingMetrics:
    """Array-native :func:`summarize`: one aligned column per completion
    field, ordered by finish time. ``summarize`` delegates here, and the
    compiled fast path of the reference feeds its reconstructed completion
    arrays in directly — one accounting implementation serves both engines. ``taus`` is the per-completion effective deadline
    (the request's own, or the global SLO where it has none)."""
    n_total = len(models)
    if warmup_tasks >= n_total:
        warmup_tasks = n_total // 2
    if n_total - warmup_tasks <= 0:
        # (late + dropped) / (done + dropped) with done empty: every
        # accounted request was shed, and a dropped request certainly
        # missed its deadline.
        return ServingMetrics(
            num_completed=0,
            violation_ratio=1.0 if dropped else 0.0,
            p50_latency=0.0,
            p95_latency=0.0, p99_latency=0.0, mean_latency=0.0,
            mean_queueing=0.0, mean_exit_depth=0.0, mean_accuracy=0.0,
            throughput=0.0, utilization=0.0, mean_batch=0.0,
            residual_queue=residual_queue, dropped=dropped, warmup_used=0,
        )
    sl = slice(warmup_tasks, None)
    lat = np.asarray(latencies, dtype=np.float64)[sl]
    queue = np.asarray(queueings, dtype=np.float64)[sl]
    exits = np.asarray(exits, dtype=np.int64)[sl]
    batches = np.asarray(batches, dtype=np.int64)[sl]
    models = np.asarray(models, dtype=np.int64)[sl]
    taus = np.asarray(taus, dtype=np.float64)[sl]
    done = lat  # alias for the count below
    rows = (
        np.asarray(model_map, dtype=np.int64)[models]
        if model_map is not None
        else models
    )
    acc = table.accuracy[rows, exits]
    if np.all(np.isnan(acc)):  # measured tables may carry no accuracy data
        acc = np.zeros_like(acc)
    violated = lat > taus
    late = int(np.sum(violated))

    # One stable sort replaces a boolean-mask pass per model: the sorted
    # order groups each model's completions into one contiguous slice.
    per_model = []
    order = np.argsort(models, kind="stable")
    groups, counts = np.unique(models[order], return_counts=True)
    bounds = np.concatenate(([0], np.cumsum(counts)))
    lat_o, queue_o = lat[order], queue[order]
    exits_o, viol_o = exits[order], violated[order]
    for gi, m in enumerate(groups):
        sel = slice(bounds[gi], bounds[gi + 1])
        pm_p50, pm_p95 = np.percentile(lat_o[sel], [50, 95])
        per_model.append(ModelMetrics(
            model=int(m),
            num_completed=int(counts[gi]),
            violation_ratio=float(viol_o[sel].mean()),
            p50_latency=float(pm_p50),
            p95_latency=float(pm_p95),
            mean_queueing=float(queue_o[sel].mean()),
            mean_exit_depth=float(exits_o[sel].mean() + 1.0),
        ))

    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return ServingMetrics(
        num_completed=len(done),
        violation_ratio=float((late + dropped) / (len(done) + dropped)),
        p50_latency=float(p50),
        p95_latency=float(p95),
        p99_latency=float(p99),
        mean_latency=float(lat.mean()),
        mean_queueing=float(queue.mean()),
        mean_exit_depth=float(exits.mean() + 1.0),
        mean_accuracy=float(np.nanmean(acc)),
        throughput=float(len(done) / span) if span > 0 else 0.0,
        utilization=float(busy_time / span) if span > 0 else 0.0,
        mean_batch=float(batches.mean()),
        residual_queue=residual_queue,
        dropped=dropped,
        warmup_used=warmup_tasks,
        per_model=tuple(per_model),
    )
