"""Event-driven time-division serving simulator (paper Sec. III + VI).

The simulator and the live serving loop (``repro_torch.runtime.server``)
share the same queues, snapshot, scheduler and metrics code; the only
difference is where service time comes from -- here it is the profile table
(optionally with the paper's measured <3% CoV noise), live it is the card.

Semantics reproduced from the paper:
  * requests arrive continuously and are enqueued regardless of accelerator
    state (arrivals during a quantum are visible at the next round);
  * scheduling happens only when the accelerator is idle; the chosen batch
    occupies it exclusively for L(m, e, B) seconds (time-division);
  * no admission control: late tasks still run and count as violations;
  * each experiment runs ``horizon`` seconds of arrivals (paper: 20 s) and
    then drains; the first ``warmup_tasks`` completions are excluded.

The event loop is host numpy float64, op for op the reference's
(``src/repro/core/simulator.py``), so with the ``numpy`` scoring backend its
metrics are bitwise the reference's. The only device work is the scheduler's
scoring round: ``SchedulerConfig(backend="cuda")`` sends each round to the
stability-score kernel. A ``tracer=`` (``repro_torch.core.telemetry``) is
record-only: decisions and metrics are bitwise those of an untraced run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.adaptive import AdaptConfig, DriftModel, make_profiler
from repro_torch.core.metrics import ServingMetrics, summarize
from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot, ServiceQueue
from repro_torch.core.request import Completion, Request, ServingTrace
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.telemetry import Trace, Tracer, decision_margin
from repro_torch.core.traffic import poisson_arrivals

__all__ = ["SimResult", "ServingSimulator", "run_experiment",
           "service_noise_multiplier"]


@dataclasses.dataclass
class SimResult:
    metrics: ServingMetrics
    completions: List[Completion]
    traces: List[ServingTrace]
    span: float
    adapted_table: Optional[ProfileTable] = None  # final online-profiler view
    trace: Optional[Trace] = None  # telemetry timeline (tracer attached)


def service_noise_multiplier(rng: np.random.Generator, cov: float) -> float:
    """Mean-1 lognormal service-time multiplier at coefficient of variation
    ``cov`` (paper: CoV < 3%). Shared by the single-device and cluster
    simulators so their noise streams stay formula-identical."""
    sigma = np.sqrt(np.log1p(cov**2))
    return float(rng.lognormal(-0.5 * sigma**2, sigma))


class ServingSimulator:
    """Deterministic discrete-event simulator for one serving experiment."""

    def __init__(
        self,
        scheduler: Scheduler,
        table: ProfileTable,
        num_models: Optional[int] = None,
        service_noise_cov: float = 0.0,
        model_map: Optional[Sequence[int]] = None,
        seed: int = 0,
        drain_cap: float = 600.0,
        drift: Optional[DriftModel] = None,
        adapt: Optional[AdaptConfig] = None,
        tracer: Optional[Tracer] = None,
    ):
        """Args:
          scheduler: the policy under test (its table may be a restricted
            view; ``table`` here is the ground-truth execution table).
          num_models: number of service queues (defaults to table rows).
          service_noise_cov: multiplicative lognormal service-time noise
            (paper measures CoV < 3%; 0 = fully deterministic).
          model_map: queue index -> execution-table row (deployment mixes).
          drain_cap: hard cap, in simulated seconds, on post-horizon
            draining.
          drift: optional ground-truth drift on *true* service times
            (``repro_torch.core.adaptive``); the scheduler's table is
            untouched, so it decides with stale estimates unless ``adapt``
            is on.
          adapt: optional online-adaptation config: observed quantum
            service times feed an ``OnlineProfiler`` over the scheduler's
            table, which is swapped for a refreshed view on the configured
            cadence. ``None`` for both knobs is bitwise the stock simulator.
          tracer: optional ``repro_torch.core.telemetry.Tracer``.
            Record-only: with a tracer attached, decisions and metrics are
            bitwise identical to an untraced run; ``None`` (the default)
            skips every telemetry branch entirely.
        """
        self.scheduler = scheduler
        self.table = table
        self.num_models = num_models or table.num_models
        self.noise_cov = service_noise_cov
        self.model_map = list(model_map) if model_map is not None else None
        self.rng = np.random.default_rng(seed ^ 0x5EED)
        self.drain_cap = drain_cap
        self.drift = drift
        self.adapt = adapt
        self.tracer = tracer
        self._seed = seed

    def _exec_row(self, m: int) -> int:
        return self.model_map[m] if self.model_map is not None else m

    def _service_time(self, m: int, e: int, batch: int, t: float = 0.0) -> float:
        base = self.table(self._exec_row(m), e, batch)
        if self.drift is not None:
            base *= self.drift.multiplier(t)
        if self.noise_cov > 0:
            base *= service_noise_multiplier(self.rng, self.noise_cov)
        return base

    def run(
        self,
        arrivals: List[Request],
        horizon: float,
        warmup_tasks: int = 100,
        keep_traces: bool = False,
    ) -> SimResult:
        queues = [ServiceQueue(m) for m in range(self.num_models)]
        completions: List[Completion] = []
        traces: List[ServingTrace] = []
        busy = 0.0
        dropped = 0
        t = 0.0
        next_arrival = 0  # index into the time-sorted arrival list
        n_arr = len(arrivals)
        # The noise stream is re-seeded per run, like drift below: a second
        # run() on the same instance with service_noise_cov > 0 must replay
        # the identical multiplier sequence, not continue the first run's
        # stream (rerun-bitwise determinism).
        self.rng = np.random.default_rng(self._seed ^ 0x5EED)
        # Drift is re-seeded per run (not per construction): a model shared
        # across simulators cannot cross-contaminate their streams, and
        # run() stays deterministic under reruns.
        if self.drift is not None:
            self.drift.reset(self._seed ^ 0xD21F)
        # Online adaptation: the profiler adapts the *scheduler's* belief
        # (which may be a restricted view); the execution table stays the
        # ground truth. The original belief is restored on exit so run()
        # stays rerunnable / sweep cells hermetic.
        profiler = make_profiler(self.scheduler.table, self.adapt)
        static_table = self.scheduler.table
        # Telemetry is record-only: every branch below guards on the tracer
        # and only ever appends to its lists, so decisions / RNG draws /
        # metrics are bitwise identical with or without one attached.
        tracer = self.tracer
        if tracer is not None:
            tracer.reset()  # rerun-determinism, like the RNG re-seed above
        slo = self.scheduler.config.slo

        def ingest(upto: float) -> int:
            nonlocal next_arrival
            while next_arrival < n_arr and arrivals[next_arrival].arrival <= upto:
                r = arrivals[next_arrival]
                queues[r.model].push(r)
                next_arrival += 1
            return next_arrival

        while True:
            ingest(t)
            snapshot = QueueSnapshot.take(queues, t)
            shed = self.scheduler.prune(snapshot)
            if shed:
                n_shed = 0
                for m, n in shed:
                    popped = queues[m].pop_batch(n)
                    n_shed += len(popped)
                    if tracer is not None:
                        for req in popped:
                            tracer.record_drop(req, t, slo)
                dropped += n_shed
                if profiler is not None:
                    profiler.observe_dropped(n_shed)
                if tracer is not None and n_shed:
                    tracer.record_event(t, "shed", n=n_shed)
                snapshot = QueueSnapshot.take(queues, t)
            decision = self.scheduler.decide(snapshot)

            if decision is None:
                # Idle: sleep until the scheduler's requested wake or the
                # next arrival, whichever is earlier.
                wake = None
                if hasattr(self.scheduler, "next_wake"):
                    wake = self.scheduler.next_wake(snapshot)
                next_t = arrivals[next_arrival].arrival if next_arrival < n_arr else None
                candidates = [x for x in (wake, next_t) if x is not None]
                if not candidates:
                    break  # no work will ever appear again
                # Strict progress: a fixed epsilon falls below half a
                # float64 ulp once t >= 16384 s and the loop would spin on a
                # scheduler whose next_wake keeps returning the same
                # instant; a one-ulp advance makes progress at any magnitude.
                t = np.nextafter(max(t, min(candidates)), np.inf)
                if t > horizon + self.drain_cap:
                    break
                continue

            service = self._service_time(decision.model, decision.exit_idx,
                                         decision.batch_size, t)
            batch = queues[decision.model].pop_batch(decision.batch_size)
            assert len(batch) == decision.batch_size, "scheduler overdrew queue"
            t_end = t + service
            busy += service
            for req in batch:
                completions.append(
                    Completion(
                        req_id=req.req_id,
                        model=req.model,
                        arrival=req.arrival,
                        dispatch=t,
                        finish=t_end,
                        exit_idx=decision.exit_idx,
                        batch_size=decision.batch_size,
                        deadline=req.deadline,
                    )
                )
            if tracer is not None:
                tracer.record_decision(
                    t, decision, t_end,
                    tuple(snapshot.qlens()),
                    tuple(snapshot.w_max(m) for m in range(self.num_models)),
                    margin=decision_margin(self.scheduler, snapshot),
                )
                for req in batch:
                    tracer.record_completion(
                        req, t, t_end, decision.exit_idx,
                        decision.batch_size, slo)
            if profiler is not None:
                refreshed = profiler.ingest_quantum(
                    decision.model, decision.exit_idx, decision.batch_size,
                    service, t_end, batch, self.scheduler.config.slo)
                if refreshed is not None:
                    self.scheduler.table = refreshed
                    if tracer is not None:
                        tracer.record_refresh(t_end, profiler)
            if keep_traces:
                traces.append(
                    ServingTrace(t, t_end, decision, tuple(snapshot.qlens()))
                )
            t = t_end
            if t > horizon + self.drain_cap:
                break

        adapted = None
        if profiler is not None:
            adapted = profiler.materialize()
            self.scheduler.table = static_table  # hermetic: rerunnable cell
        residual = sum(len(q) for q in queues) + (n_arr - next_arrival)
        span = max(t, horizon)
        metrics = summarize(
            completions,
            self.table,
            self.scheduler.config.slo,
            warmup_tasks=warmup_tasks,
            busy_time=busy,
            span=span,
            residual_queue=residual,
            model_map=self.model_map,
            dropped=dropped,
        )
        trace = None
        if tracer is not None:
            # Never served (still queued at run end, or never ingested):
            # device=-1 throughout — a residual was never assigned a
            # quantum.
            for q in queues:
                for req in q.pending():
                    tracer.record_residual(req, slo, device=-1)
            for req in arrivals[next_arrival:]:
                tracer.record_residual(req, slo, device=-1)
            trace = tracer.freeze(
                engine="python", num_models=self.num_models, num_devices=1,
                slo=slo, horizon=horizon, span=span,
                warmup_used=metrics.warmup_used, n_arrivals=n_arr)
        return SimResult(metrics, completions, traces, span,
                         adapted_table=adapted, trace=trace)


def run_experiment(
    scheduler: Scheduler,
    table: ProfileTable,
    rates: Sequence[float],
    horizon: float = 20.0,
    seed: int = 0,
    warmup_tasks: int = 100,
    service_noise_cov: float = 0.0,
    model_map: Optional[Sequence[int]] = None,
    keep_traces: bool = False,
    process: Optional[object] = None,
    drift: Optional[DriftModel] = None,
    adapt: Optional[AdaptConfig] = None,
    tracer: Optional[Tracer] = None,
) -> SimResult:
    """One full serving experiment: arrivals -> simulate -> metrics.

    ``process`` is an optional ``repro_torch.core.workloads.ArrivalProcess``;
    the default is the paper's stationary Poisson traffic at ``rates``.
    ``drift`` / ``adapt`` / ``tracer`` thread straight into
    :class:`ServingSimulator` (device drift on true service times / online
    profile adaptation / record-only telemetry).
    """
    if process is not None:
        arrivals = process.generate(horizon, seed=seed)
    else:
        arrivals = poisson_arrivals(rates, horizon, seed=seed)
    sim = ServingSimulator(
        scheduler,
        table,
        num_models=len(rates),
        service_noise_cov=service_noise_cov,
        model_map=model_map,
        seed=seed,
        drift=drift,
        adapt=adapt,
        tracer=tracer,
    )
    return sim.run(arrivals, horizon, warmup_tasks=warmup_tasks,
                   keep_traces=keep_traces)
