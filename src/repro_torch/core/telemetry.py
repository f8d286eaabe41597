"""Serving telemetry: decision/request/event timelines behind one tracer.

``ServingMetrics`` answers *how much* went wrong over a window; this module
answers *why*: which scheduling decisions, against which queue state,
produced a violation spike. A record-only :class:`Tracer` is threaded
through the serving engines of the port (the Python ``ServingSimulator``,
the ``ClusterSimulator`` and the live
``repro_torch.runtime.server.ServingEngine``) and captures three record
kinds:

  * :class:`DecisionRecord` — one per dispatched quantum: time, device, the
    chosen (model, exit, batch), the winning stability score and the
    *decision margin* (runner-up candidate score minus the winner's — how
    contested the Eq. 7 argmin was), and the per-queue depth / oldest-age
    snapshot the scheduler actually saw.
  * :class:`RequestSpan` — one per *arrival*: arrival -> dispatch ->
    completion (or drop, or residual), with the effective deadline and the
    signed slack. Span accounting is conservative by construction:
    ``len(trace.spans) == arrivals == completed + dropped + residual``.
  * :class:`TraceEvent` — discrete happenings: device failure/failover,
    Symphony shedding, ``OnlineProfiler`` table refreshes,
    ``SafetyController`` multiplier changes, live-engine counters.

Tracing is **off by default and zero-cost when off**: every producer guards
on ``tracer is not None``, and the tracer only ever *appends to Python
lists* (it never reads the RNG, never touches float state the engines
compute with), so decisions and ``ServingMetrics`` are bitwise-identical
with tracing on or off.

Consumers: :func:`timeline_metrics` (time-binned violation / queue-depth /
utilization / exit-depth rollups), :func:`export_chrome_trace` (Chrome
trace-event JSON loadable in Perfetto: quanta as duration events per device
track, decisions/events as instants, request lifecycles as async spans) and
:func:`export_ndjson` / :func:`load_ndjson` (lossless line-oriented
interchange, the ``tools/tracestats.py`` CLI's native format). Records,
exporters and their bytes are the reference's (``src/repro/core/
telemetry.py``), so one ``tools/tracestats.py`` reads the files of either.

Host numpy throughout. The one place a trace reaches the card is
:func:`decision_margin`, which re-scores a snapshot through the scheduler's
own backend: with ``backend="cuda"`` that is one more stability-kernel
launch per traced round with two or more candidates, and the margin is
float32-derived (decisions and spans stay exact).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.baselines import (
    AllFinalDeadlineAwareScheduler,
    NoBatchingScheduler,
)
from repro_torch.core.queues import QueueSnapshot
from repro_torch.core.request import Decision, Request
from repro_torch.core.scheduler import (
    EdgeServingScheduler,
    LatticeEdgeServingScheduler,
    Scheduler,
    VectorizedEdgeServingScheduler,
)

__all__ = [
    "DecisionRecord",
    "EVENT_KINDS",
    "RequestSpan",
    "TimelineMetrics",
    "Trace",
    "TraceEvent",
    "Tracer",
    "decision_margin",
    "export_chrome_trace",
    "export_ndjson",
    "load_ndjson",
    "timeline_metrics",
]

TRACE_VERSION = 1

#: The shared event vocabulary (sims and live runs emit the same kinds, so
#: one ``tools/tracestats.py`` invocation reads either).
EVENT_KINDS = (
    "device-failure",    # a DeviceSpec.fail_at fired
    "failover",          # the dead device's queue was re-dispatched
    "shed",              # admission control dropped expired requests
    "overflow-retry",    # the reference's scan engine doubled its window
    "profiler-refresh",  # OnlineProfiler handed the scheduler a new table
    "safety-multiplier", # SafetyController moved its multiplier
    "engine-counters",   # live-engine run() exit summary
)

#: Span lifecycle outcomes.
SPAN_COMPLETED = "completed"
SPAN_DROPPED = "dropped"
SPAN_RESIDUAL = "residual"


# ---------------------------------------------------------------------------
# Record types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One dispatched scheduling decision and the state it was made against.

    ``margin`` is the runner-up candidate's stability score minus the
    winner's (>= 0): 0 means the Eq. 7 argmin was a structural tie decided
    by the tiebreak, ``inf`` means there was only one candidate, ``NaN``
    means the policy is outside the Algorithm-1 scored family (LQF / EDF /
    Symphony decide by other rules). ``score``/``margin`` come from the
    engine's own scoring pass, so they may differ at the ulp level between
    engines (summation order); everything else is bitwise.
    """

    t: float                        # dispatch time (snapshot time)
    device: int                     # 0 for single-accelerator runs
    model: int
    exit_idx: int
    batch_size: int
    predicted_latency: float        # scheduler-belief L(m, e, B)
    t_end: float                    # quantum end (t + executed service)
    score: float                    # winning stability score (NaN if unscored)
    margin: float                   # runner-up score - winning score
    queue_depths: Tuple[int, ...]   # per-queue length at decision time
    oldest_ages: Tuple[float, ...]  # per-queue w_max at decision time


@dataclasses.dataclass(frozen=True)
class RequestSpan:
    """One request's lifecycle: arrival -> dispatch -> completion/drop.

    ``status``: ``"completed"`` (served; ``finish`` is the quantum end),
    ``"dropped"`` (shed by admission control; ``finish`` is the drop time,
    ``dispatch``/``exit_idx`` are NaN/-1), or ``"residual"`` (never served
    before the run ended; ``dispatch``/``finish``/``slack`` are NaN).
    ``slack = deadline - (finish - arrival)``: negative means the request
    violated its effective deadline.
    """

    req_id: int
    model: int
    device: int                     # -1 when never assigned to a device
    arrival: float
    dispatch: float
    finish: float
    deadline: float                 # effective (own deadline or global SLO)
    slack: float
    exit_idx: int
    batch_size: int
    status: str


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """A discrete happening on a device timeline (see :data:`EVENT_KINDS`)."""

    t: float
    kind: str
    device: int = 0
    payload: Tuple[Tuple[str, object], ...] = ()

    def payload_dict(self) -> Dict[str, object]:
        return dict(self.payload)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A frozen telemetry timeline (what ``Tracer.freeze`` returns and what
    ``SimResult.trace`` / ``ClusterResult.trace`` carry)."""

    decisions: Tuple[DecisionRecord, ...]
    spans: Tuple[RequestSpan, ...]
    events: Tuple[TraceEvent, ...]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def span_counts(self) -> Dict[str, int]:
        """``{status: count}`` over the spans (conservation check helper)."""
        out = {SPAN_COMPLETED: 0, SPAN_DROPPED: 0, SPAN_RESIDUAL: 0}
        for s in self.spans:
            out[s.status] = out.get(s.status, 0) + 1
        return out

    @property
    def num_devices(self) -> int:
        if "num_devices" in self.meta:
            return int(self.meta["num_devices"])  # engines stamp this
        devs = [r.device for r in self.decisions]
        return (max(devs) + 1) if devs else 1

    def end_time(self) -> float:
        """Last timestamp anywhere in the trace (fallback: meta ``span``)."""
        t = float(self.meta.get("span", 0.0))
        for r in self.decisions:
            t = max(t, r.t_end)
        for s in self.spans:
            if math.isfinite(s.finish):
                t = max(t, s.finish)
        for e in self.events:
            if math.isfinite(e.t):
                t = max(t, e.t)
        return t


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Record-only telemetry sink threaded through the serving engines.

    The tracer is deliberately inert: it appends records to lists and does
    nothing else — no RNG, no arithmetic shared with the engine's decision
    path — so attaching one cannot change decisions or metrics (the
    bitwise guarantee ``tests/test_torch_telemetry.py`` pins). Engines call
    :meth:`reset` at the top of ``run()`` so a rerun re-records from
    scratch (rerun-determinism, like the simulator's RNG re-seed).
    """

    def __init__(self) -> None:
        self.decisions: List[DecisionRecord] = []
        self.spans: List[RequestSpan] = []
        self.events: List[TraceEvent] = []
        self._safety_mult: Dict[int, float] = {}  # last seen, per device

    def reset(self) -> None:
        self.decisions.clear()
        self.spans.clear()
        self.events.clear()
        self._safety_mult.clear()

    # -- producers -----------------------------------------------------------

    def record_decision(
        self,
        t: float,
        decision: Decision,
        t_end: float,
        queue_depths: Tuple[int, ...],
        oldest_ages: Tuple[float, ...],
        margin: float = float("nan"),
        device: int = 0,
    ) -> None:
        self.decisions.append(DecisionRecord(
            t=t,
            device=device,
            model=decision.model,
            exit_idx=decision.exit_idx,
            batch_size=decision.batch_size,
            predicted_latency=decision.predicted_latency,
            t_end=t_end,
            score=decision.stability_score,
            margin=margin,
            queue_depths=queue_depths,
            oldest_ages=oldest_ages,
        ))

    def record_completion(self, req: Request, dispatch: float, finish: float,
                          exit_idx: int, batch_size: int, default_slo: float,
                          device: int = 0) -> None:
        tau = default_slo if req.deadline is None else req.deadline
        self.spans.append(RequestSpan(
            req_id=req.req_id, model=req.model, device=device,
            arrival=req.arrival, dispatch=dispatch, finish=finish,
            deadline=tau, slack=tau - (finish - req.arrival),
            exit_idx=exit_idx, batch_size=batch_size, status=SPAN_COMPLETED,
        ))

    def record_drop(self, req: Request, t: float, default_slo: float,
                    device: int = 0) -> None:
        tau = default_slo if req.deadline is None else req.deadline
        self.spans.append(RequestSpan(
            req_id=req.req_id, model=req.model, device=device,
            arrival=req.arrival, dispatch=float("nan"), finish=t,
            deadline=tau, slack=tau - (t - req.arrival),
            exit_idx=-1, batch_size=0, status=SPAN_DROPPED,
        ))

    def record_residual(self, req: Request, default_slo: float,
                        device: int = -1) -> None:
        tau = default_slo if req.deadline is None else req.deadline
        self.spans.append(RequestSpan(
            req_id=req.req_id, model=req.model, device=device,
            arrival=req.arrival, dispatch=float("nan"), finish=float("nan"),
            deadline=tau, slack=float("nan"),
            exit_idx=-1, batch_size=0, status=SPAN_RESIDUAL,
        ))

    def record_event(self, t: float, kind: str, device: int = 0,
                     **payload) -> None:
        self.events.append(TraceEvent(
            t=t, kind=kind, device=device,
            payload=tuple(payload.items()),
        ))

    def record_refresh(self, t: float, profiler, device: int = 0) -> None:
        """One ``OnlineProfiler`` table refresh; also detects and emits
        ``SafetyController`` multiplier changes since the last refresh."""
        self.record_event(
            t, "profiler-refresh", device=device,
            observations=int(profiler.num_observations),
            drift_ratio=float(profiler.drift_ratio),
        )
        if profiler.safety is not None:
            mult = float(profiler.safety.multiplier)
            last = self._safety_mult.get(device)
            if last is not None and mult != last:
                self.record_event(t, "safety-multiplier", device=device,
                                  previous=last, multiplier=mult)
            self._safety_mult[device] = mult

    # -- finalisation --------------------------------------------------------

    def freeze(self, **meta) -> Trace:
        """Snapshot the recorded timeline as an immutable :class:`Trace`.
        ``meta`` should carry at least ``engine`` / ``num_models`` /
        ``num_devices`` / ``slo`` / ``horizon`` / ``span`` /
        ``warmup_used`` / ``n_arrivals`` (the engines do)."""
        meta.setdefault("version", TRACE_VERSION)
        return Trace(
            decisions=tuple(self.decisions),
            spans=tuple(self.spans),
            events=tuple(self.events),
            meta=meta,
        )


# ---------------------------------------------------------------------------
# Decision margin (shared by the Python engines and the live engine)
# ---------------------------------------------------------------------------

# The Algorithm-1 scored family: decisions are the Eq. 7 argmin over the
# shared enumerate/score path, so re-scoring the snapshot reproduces the
# candidate scores the decision ranked. Exact types (the reference's
# family): an unknown subclass may decide by other rules, where a "margin"
# would be meaningless.
_SCORED_FAMILY = (
    EdgeServingScheduler,
    VectorizedEdgeServingScheduler,
    LatticeEdgeServingScheduler,
    AllFinalDeadlineAwareScheduler,
    NoBatchingScheduler,
)


def decision_margin(scheduler: Scheduler, snapshot: QueueSnapshot) -> float:
    """Runner-up candidate score minus the winner's for this snapshot.

    Computed by re-scoring through the scheduler's own shared
    ``enumerate_candidates`` / ``score_candidates`` path (read-only; the
    snapshot is immutable), so tracing never perturbs the decision itself.
    Returns ``inf`` with a single candidate, 0.0 on an exact score tie, and
    ``NaN`` for policies outside the Algorithm-1 scored family. The margin
    reflects the *vectorised* scoring pass, which can differ from the
    paper-exact loop's accumulated score at the ulp level (the repo's
    decision-equivalence tests pin that both rank candidates identically).
    """
    if type(scheduler) not in _SCORED_FAMILY:
        return float("nan")
    cand_queue, batches, exits, lats, _w = scheduler.enumerate_candidates(
        snapshot)
    n = len(cand_queue)
    if n == 0:
        return float("nan")
    if n == 1:
        return float("inf")
    scores = scheduler.score_candidates(snapshot, lats, batches, cand_queue)
    two = np.partition(np.asarray(scores, dtype=np.float64), 1)[:2]
    return float(two[1] - two[0])


# ---------------------------------------------------------------------------
# Time-binned rollups
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimelineMetrics:
    """Per-bin rollups computed from a :class:`Trace`.

    Completions are attributed to the bin their *finish* lands in (drops to
    their drop time, decisions/queue depths to their dispatch time);
    everything past the last edge clips into the final bin so totals are
    conserved. With ``warmup`` matching the aggregate's ``warmup_used``,
    :meth:`aggregate_violation_ratio` reproduces
    ``ServingMetrics.violation_ratio`` exactly (tested).
    """

    edges: np.ndarray            # [K+1] bin edges, seconds
    completed: np.ndarray        # [K] post-warmup completions per bin
    late: np.ndarray             # [K] of those, deadline violations
    dropped: np.ndarray          # [K] shed requests per bin
    violation_ratio: np.ndarray  # [K] (late+dropped)/(completed+dropped)
    queue_depth: np.ndarray      # [K] mean total queued at decision times
    utilization: np.ndarray      # [K] busy fraction (quantum-bin overlap)
    mean_exit_depth: np.ndarray  # [K] 1..E over completions in bin

    @property
    def num_bins(self) -> int:
        return len(self.completed)

    @property
    def centers(self) -> np.ndarray:
        return 0.5 * (self.edges[:-1] + self.edges[1:])

    def aggregate_violation_ratio(self) -> float:
        """``(sum(late) + sum(dropped)) / (sum(completed) + sum(dropped))``
        — the same Eq. 2 accounting ``summarize`` applies."""
        done = int(self.completed.sum())
        drop = int(self.dropped.sum())
        late = int(self.late.sum())
        if done + drop == 0:
            return 0.0
        return float((late + drop) / (done + drop))


def timeline_metrics(
    trace: Trace,
    num_bins: int = 40,
    t_end: Optional[float] = None,
    warmup: Optional[int] = None,
) -> TimelineMetrics:
    """Bin a trace into ``num_bins`` equal windows over ``[0, t_end]``.

    ``t_end`` defaults to the trace's own end time; ``warmup`` (defaults to
    the trace's ``meta["warmup_used"]``) excludes the first N completions
    *in finish order* from the violation / exit-depth accounting, matching
    ``summarize``'s warmup rule so the binned ratios sum back to the
    aggregate exactly.
    """
    assert num_bins >= 1
    if warmup is None:
        warmup = int(trace.meta.get("warmup_used", 0))
    T = float(t_end if t_end is not None else trace.end_time())
    T = max(T, 1e-12)
    edges = np.linspace(0.0, T, num_bins + 1)

    def _bin(times: np.ndarray) -> np.ndarray:
        return np.clip(np.searchsorted(edges, times, side="right") - 1,
                       0, num_bins - 1)

    comp = [s for s in trace.spans if s.status == SPAN_COMPLETED]
    comp.sort(key=lambda s: s.finish)  # cluster merges are per-device
    comp = comp[warmup:]
    drops = [s for s in trace.spans if s.status == SPAN_DROPPED]

    completed = np.zeros(num_bins, dtype=np.int64)
    late = np.zeros(num_bins, dtype=np.int64)
    exit_sum = np.zeros(num_bins, dtype=np.float64)
    if comp:
        fin = np.array([s.finish for s in comp])
        slack = np.array([s.slack for s in comp])
        exits = np.array([s.exit_idx for s in comp], dtype=np.int64)
        b = _bin(fin)
        completed = np.bincount(b, minlength=num_bins)
        late = np.bincount(b[slack < 0], minlength=num_bins)
        exit_sum = np.bincount(b, weights=exits + 1.0, minlength=num_bins)
    dropped = np.zeros(num_bins, dtype=np.int64)
    if drops:
        dropped = np.bincount(_bin(np.array([s.finish for s in drops])),
                              minlength=num_bins)

    depth = np.full(num_bins, np.nan)
    busy = np.zeros(num_bins, dtype=np.float64)
    if trace.decisions:
        t0 = np.array([r.t for r in trace.decisions])
        t1 = np.array([r.t_end for r in trace.decisions])
        totals = np.array([sum(r.queue_depths) for r in trace.decisions],
                          dtype=np.float64)
        b = _bin(t0)
        counts = np.bincount(b, minlength=num_bins)
        sums = np.bincount(b, weights=totals, minlength=num_bins)
        np.divide(sums, counts, out=depth, where=counts > 0)
        # busy seconds per bin: overlap of each quantum with each window
        lo = np.maximum(edges[:-1][:, None], t0[None, :])
        hi = np.minimum(edges[1:][:, None], np.minimum(t1, T)[None, :])
        busy = np.clip(hi - lo, 0.0, None).sum(axis=1)

    width = T / num_bins
    util = busy / (width * trace.num_devices)
    denom = completed + dropped
    viol = np.full(num_bins, np.nan)
    np.divide(late + dropped, denom, out=viol, where=denom > 0)
    return TimelineMetrics(
        edges=edges, completed=completed, late=late, dropped=dropped,
        violation_ratio=viol, queue_depth=depth, utilization=util,
        mean_exit_depth=np.divide(
            exit_sum, completed, out=np.full(num_bins, np.nan),
            where=completed > 0),
    )


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


def _enc(v):
    """JSON-safe scalar: non-finite floats become tagged strings (NDJSON is
    lossless; strict JSON has no NaN/Infinity literals)."""
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return "NaN"
        return "Infinity" if v > 0 else "-Infinity"
    return v


def _dec(v):
    if v in ("NaN", "Infinity", "-Infinity"):
        return float(v.replace("Infinity", "inf"))
    return v


def export_ndjson(trace: Trace, path: str) -> str:
    """Write the trace as newline-delimited JSON (one record per line; the
    first line is the meta header). Lossless: :func:`load_ndjson` restores
    an equal :class:`Trace`. This is ``tools/tracestats.py``'s native
    format."""
    with open(path, "w") as f:
        json.dump({"type": "meta",
                   **{k: _enc(v) for k, v in trace.meta.items()}}, f)
        f.write("\n")
        for r in trace.decisions:
            json.dump({
                "type": "decision", "t": r.t, "device": r.device,
                "model": r.model, "exit": r.exit_idx, "batch": r.batch_size,
                "lat": r.predicted_latency, "t_end": r.t_end,
                "score": _enc(r.score), "margin": _enc(r.margin),
                "depths": list(r.queue_depths),
                "ages": list(r.oldest_ages),
            }, f)
            f.write("\n")
        for s in trace.spans:
            json.dump({
                "type": "span", "req": s.req_id, "model": s.model,
                "device": s.device, "arrival": s.arrival,
                "dispatch": _enc(s.dispatch), "finish": _enc(s.finish),
                "deadline": s.deadline, "slack": _enc(s.slack),
                "exit": s.exit_idx, "batch": s.batch_size,
                "status": s.status,
            }, f)
            f.write("\n")
        for e in trace.events:
            json.dump({
                "type": "event", "t": _enc(e.t), "kind": e.kind,
                "device": e.device,
                "payload": {k: _enc(v) for k, v in e.payload},
            }, f)
            f.write("\n")
    return path


def load_ndjson(path: str) -> Trace:
    """Read a :func:`export_ndjson` file back into a :class:`Trace`."""
    decisions: List[DecisionRecord] = []
    spans: List[RequestSpan] = []
    events: List[TraceEvent] = []
    meta: Dict[str, object] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            kind = d.pop("type")
            if kind == "meta":
                meta = {k: _dec(v) for k, v in d.items()}
            elif kind == "decision":
                decisions.append(DecisionRecord(
                    t=d["t"], device=d["device"], model=d["model"],
                    exit_idx=d["exit"], batch_size=d["batch"],
                    predicted_latency=d["lat"], t_end=d["t_end"],
                    score=_dec(d["score"]), margin=_dec(d["margin"]),
                    queue_depths=tuple(d["depths"]),
                    oldest_ages=tuple(d["ages"]),
                ))
            elif kind == "span":
                spans.append(RequestSpan(
                    req_id=d["req"], model=d["model"], device=d["device"],
                    arrival=d["arrival"], dispatch=_dec(d["dispatch"]),
                    finish=_dec(d["finish"]), deadline=d["deadline"],
                    slack=_dec(d["slack"]), exit_idx=d["exit"],
                    batch_size=d["batch"], status=d["status"],
                ))
            elif kind == "event":
                events.append(TraceEvent(
                    t=_dec(d["t"]), kind=d["kind"], device=d["device"],
                    payload=tuple(d["payload"].items()),
                ))
            else:
                raise ValueError(f"unknown NDJSON record type {kind!r}")
    return Trace(decisions=tuple(decisions), spans=tuple(spans),
                 events=tuple(events), meta=meta)


def _chrome_args(d: Dict[str, object]) -> Dict[str, object]:
    """Chrome args must be strict JSON: non-finite floats become null."""
    return {
        k: (None if isinstance(v, float) and not math.isfinite(v) else v)
        for k, v in d.items()
    }


def export_chrome_trace(trace: Trace, path: str) -> str:
    """Write Chrome trace-event JSON loadable in Perfetto / chrome://tracing.

    Layout: pid 1 holds one thread per device carrying the dispatched
    quanta as complete (``X``) duration events plus a ``decision`` instant
    (score / margin / queue depths) at each dispatch; pid 2 holds request
    lifecycles as async ``b``/``e`` span pairs keyed by request id (async
    events overlap cleanly, which batched requests always do), with
    residual requests as instants; discrete :class:`TraceEvent`\\ s are
    instants on their device's pid-1 track. Timestamps are microseconds.
    Strict JSON throughout (``allow_nan=False``): Perfetto's parser
    rejects bare ``NaN`` literals.
    """
    us = 1e6
    ev: List[Dict[str, object]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "ts": 0,
         "args": {"name": "devices (quanta + decisions)"}},
        {"ph": "M", "name": "process_name", "pid": 2, "ts": 0,
         "args": {"name": "requests (lifecycle spans)"}},
    ]
    devices = sorted(
        {r.device for r in trace.decisions}
        | {e.device for e in trace.events}
        | {s.device for s in trace.spans if s.device >= 0}
        | {0}
    )
    for d in devices:
        ev.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": d,
                   "ts": 0, "args": {"name": f"device {d}"}})
        ev.append({"ph": "M", "name": "thread_name", "pid": 2, "tid": d,
                   "ts": 0, "args": {"name": f"device {d} requests"}})
    for r in trace.decisions:
        ev.append({
            "ph": "X", "pid": 1, "tid": r.device, "cat": "quantum",
            "name": f"m{r.model}/e{r.exit_idx}/B{r.batch_size}",
            "ts": r.t * us, "dur": max((r.t_end - r.t) * us, 0.0),
            "args": _chrome_args({
                "score": r.score, "margin": r.margin,
                "predicted_latency_ms": r.predicted_latency * 1e3,
                "queue_depths": list(r.queue_depths),
            }),
        })
        ev.append({
            "ph": "i", "s": "t", "pid": 1, "tid": r.device,
            "cat": "decision", "name": "decision", "ts": r.t * us,
            "args": _chrome_args({
                "model": r.model, "exit": r.exit_idx,
                "batch": r.batch_size, "score": r.score,
                "margin": r.margin,
                "queue_depths": list(r.queue_depths),
                "oldest_ages_ms": [a * 1e3 for a in r.oldest_ages],
            }),
        })
    for s in trace.spans:
        tid = max(s.device, 0)
        if s.status == SPAN_RESIDUAL:
            ev.append({
                "ph": "i", "s": "t", "pid": 2, "tid": tid, "cat": "residual",
                "name": "residual", "ts": s.arrival * us,
                "args": {"req": s.req_id, "model": s.model},
            })
            continue
        sid = f"0x{s.req_id:x}"
        ev.append({
            "ph": "b", "pid": 2, "tid": tid, "cat": "request", "id": sid,
            "name": f"m{s.model}", "ts": s.arrival * us,
            "args": _chrome_args({
                "req": s.req_id, "model": s.model, "status": s.status,
                "deadline_ms": s.deadline * 1e3, "slack_ms": s.slack * 1e3,
                "exit": s.exit_idx, "batch": s.batch_size,
            }),
        })
        ev.append({
            "ph": "e", "pid": 2, "tid": tid, "cat": "request", "id": sid,
            "name": f"m{s.model}", "ts": s.finish * us,
        })
    for e in trace.events:
        t = e.t if math.isfinite(e.t) else trace.end_time()
        ev.append({
            "ph": "i", "s": "t", "pid": 1, "tid": max(e.device, 0),
            "cat": "event", "name": e.kind, "ts": t * us,
            "args": _chrome_args(dict(e.payload)),
        })
    doc = {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {k: str(v) for k, v in trace.meta.items()},
    }
    with open(path, "w") as f:
        json.dump(doc, f, allow_nan=False)
    return path
