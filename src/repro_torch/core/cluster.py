"""Cluster serving: multi-device dispatch over per-device Algorithm-1 schedulers.

The paper's scheduler shares *one* accelerator; the ROADMAP's north star is
heavy traffic sharded across many. This module scales the single-device
story out deterministically: G devices each run their own Algorithm-1
scheduler (any registered policy) over their *own* :class:`ProfileTable` —
including heterogeneous fleets mixing fast and slow hardware — behind a
first-class :class:`Dispatcher` policy family shared with the live
:class:`repro_torch.runtime.router.ReplicaRouter`.

Three layers:

  * **Dispatchers** route each arrival to one eligible device through the
    abstract :class:`DeviceLoadView` (the live router and the simulator both
    implement it, so the selection math is written once):
    ``round-robin``, ``jsq`` (join-shortest-queue by queued tasks),
    ``least-loaded`` (capacity-weighted expected drain time — the
    ReplicaRouter default), and ``stability-aware`` — a power-of-d sampler
    that routes to the device whose predicted per-device stability-score
    delta (Eq. 3 urgency the request will have accrued at its predicted
    completion on that device) is smallest.
  * **Placement**: a :class:`DeviceSpec` may restrict which models a device
    hosts; the dispatcher only considers devices hosting the request's
    model. Every device keeps one FIFO queue per *global* model index, so a
    single-device cluster is literally the single-device simulator.
  * **ClusterSimulator**: a global time-ordered event loop (failure <
    arrival < device-round at equal timestamps, then device id) in which
    each device reproduces ``ServingSimulator``'s per-round semantics
    exactly — a G=1 cluster is bitwise-identical to the single-device
    simulator on the same trace (tested in ``tests/test_torch_cluster.py``).

Host numpy float64, op for op the reference's (``src/repro/core/
cluster.py``): the one global event loop, its tie order, the ``nextafter``
wakes and the dispatchers' RNG draws are the reference's, so with the
``numpy`` scoring backend a cluster's metrics are bitwise the reference's.
The only device work is each device's scoring round:
``SchedulerConfig(backend="cuda")`` gives every device's scheduler the one
cached ``cuda`` backend, which the devices take in turn, one round at a
time (a round ends in a synchronise, so no round reuses its staging buffer
while another's copy is in flight).

Failure semantics: at a device's ``fail_at`` time it is marked dead and
excluded from dispatch; its in-flight quantum completes (results are
delivered), and its queued requests are immediately re-dispatched through
the dispatcher to surviving eligible devices in (arrival, req_id) order,
keeping their original arrival times (honest waiting-time accounting). If a
model has no surviving host, its requests strand and count as residual.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.adaptive import (
    AdaptConfig,
    DriftModel,
    OnlineProfiler,
    make_profiler,
)
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.metrics import DeviceMetrics, ServingMetrics, summarize
from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot, ServiceQueue
from repro_torch.core.request import Completion, Request
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.simulator import service_noise_multiplier
from repro_torch.core.telemetry import Trace, Tracer, decision_margin
from repro_torch.core.urgency import DEFAULT_CLIP, urgency_np

__all__ = [
    "ClusterResult",
    "ClusterSimulator",
    "DeviceLoadView",
    "DeviceSpec",
    "Dispatcher",
    "DISPATCHERS",
    "FLEETS",
    "JoinShortestQueueDispatcher",
    "LeastLoadedDispatcher",
    "RoundRobinDispatcher",
    "StabilityAwareDispatcher",
    "drain_estimate",
    "make_dispatcher",
    "make_fleet",
]

# Idle wake-ups advance by one float64 ulp (np.nextafter), matching
# ServingSimulator's idle-advance so a G=1 cluster schedules at
# bit-identical timestamps (waits feed the stability score directly).
# A fixed epsilon would stall below float64 resolution at large t.


# ---------------------------------------------------------------------------
# Closed-form drain estimate (shared with ReplicaRouter.backlog_from_scheduler)
# ---------------------------------------------------------------------------


def drain_cell(
    scheduler: Scheduler, model: int, qlen: int,
    exit_idx: Optional[int] = None,
) -> float:
    """Drain time of one ``(model, qlen)`` queue in isolation.

    Closed form over the Eq. 5 rule ``B* = min(|Q|, B_cap)``: the queue
    drains as ``n // B_cap`` full batches plus one remainder rung, so the
    O(queue-length) serve-loop collapses to a quotient and a lookup.
    ``B_cap`` is read from the policy itself (``scheduler.batch_size``), so a
    bs=1 ablation or a small-``B_max`` deployment advertises its true
    (slower) drain time. The closed form is used only for policies running
    the stock Eq. 5 implementation (where it is provably exact); a policy
    that *overrides* ``batch_size`` with its own ladder is served out
    exactly by the O(queue-length) loop instead. Exit defaults to the
    deepest (conservative).
    """
    table = scheduler.table
    e = table.num_exits - 1 if exit_idx is None else exit_idx
    n = int(qlen)
    if n <= 0:
        return 0.0
    if type(scheduler).batch_size is not Scheduler.batch_size:
        sub = 0.0  # custom ladder: serve it out exactly
        while n > 0:
            b = scheduler.batch_size(n)
            sub += table(model, e, b)
            n -= b
        return sub
    cap = scheduler.batch_size(n)
    full, rem = divmod(n, cap)
    sub = full * table(model, e, cap)
    if rem:
        sub += table(model, e, rem)
    return sub


def drain_estimate(
    scheduler: Scheduler, qlens: Sequence[int], exit_idx: Optional[int] = None
) -> float:
    """Expected time to drain ``qlens`` under the scheduler's batch ladder:
    one :func:`drain_cell` per queue, accumulated per-model-subtotal-first
    so the sum is a fixed left-to-right fold over model index (the
    reference's fold; it differs from a fully interleaved accumulation only
    in float summation order)."""
    total = 0.0
    for m, n in enumerate(qlens):
        if int(n) <= 0:
            continue
        total += drain_cell(scheduler, m, n, exit_idx)
    return total


# ---------------------------------------------------------------------------
# Dispatcher policy family
# ---------------------------------------------------------------------------


class DeviceLoadView:
    """What a dispatcher may observe about the fleet.

    Implemented by both :class:`ClusterSimulator` (live queue state, exact
    drain estimates) and :class:`repro_torch.runtime.router.ReplicaRouter`
    (reported backlogs, straggler-scaled). All methods are O(1)-ish per
    device; dispatchers touch O(G) (or O(d) for power-of-d) per request.
    """

    def healthy(self, d: int) -> bool:
        raise NotImplementedError

    def effective_backlog(self, d: int) -> float:
        """Expected seconds until device ``d`` drains its current work,
        scaled by its capacity/straggler multiplier."""
        raise NotImplementedError

    def total_queued(self, d: int) -> int:
        """Number of requests currently queued on device ``d``."""
        raise NotImplementedError

    def predicted_completion(self, d: int, model: int) -> float:
        """Predicted end-to-end latency a ``model`` request dispatched now
        would see on device ``d`` (backlog + its own service time there)."""
        raise NotImplementedError


class Dispatcher:
    """Maps one arrival to one eligible device. Stateful dispatchers
    (round-robin counter, power-of-d RNG) are reset per experiment via
    :meth:`reset` so sweep cells stay hermetic. ``deadline`` is the
    request's own SLO when it carries one (heterogeneous-SLO workloads);
    load-only policies ignore it."""

    name = "base"

    def reset(self, seed: int = 0) -> None:
        pass

    def pick(self, model: int, eligible: Sequence[int],
             view: DeviceLoadView, deadline: Optional[float] = None) -> int:
        raise NotImplementedError


class RoundRobinDispatcher(Dispatcher):
    """Cycle through eligible devices, blind to load and capacity."""

    name = "round-robin"

    def __init__(self):
        self._i = 0

    def reset(self, seed: int = 0) -> None:
        self._i = 0

    def pick(self, model, eligible, view, deadline=None):
        d = eligible[self._i % len(eligible)]
        self._i += 1
        return d


class JoinShortestQueueDispatcher(Dispatcher):
    """Fewest queued requests wins (ties -> lowest device id). Blind to
    device speed: on heterogeneous fleets a short queue on slow hardware
    still means a long wait — exactly what fig14's het leg exposes."""

    name = "jsq"

    def pick(self, model, eligible, view, deadline=None):
        return min(eligible, key=lambda d: (view.total_queued(d), d))


class LeastLoadedDispatcher(Dispatcher):
    """Capacity-weighted least-loaded: smallest straggler/capacity-scaled
    expected drain time (ties -> lowest device id). This is the selection
    rule :class:`repro_torch.runtime.router.ReplicaRouter` uses; it lives
    here so the simulator and the live router share one implementation.
    """

    name = "least-loaded"

    def pick(self, model, eligible, view, deadline=None):
        return min(eligible, key=lambda d: (view.effective_backlog(d), d))


class StabilityAwareDispatcher(Dispatcher):
    """Power-of-d stability-aware dispatch.

    Samples ``d`` distinct eligible devices (seeded RNG; classic
    power-of-d-choices keeps per-request cost O(d) while capturing most of
    the benefit of a full scan) and routes to the one whose predicted
    per-device stability-score delta is smallest: the Eq. 3 urgency
    ``f(T_hat) = min(exp(T_hat / tau - 1), C)`` the request will have
    accrued at its predicted completion ``T_hat`` on that device — i.e. the
    request's own contribution to that device's stability score at service
    time. ``tau`` is the request's own deadline when it carries one
    (heterogeneous-SLO workloads), else the constructor ``slo``.

    Because f is monotone non-decreasing in ``T_hat`` for the request's
    single tau, ``argmin f(T_hat)`` equals ``argmin T_hat`` — so the pick
    is computed directly on predicted completion (no exponentials on the
    dispatch path; ``slo``/``clip`` define the delta's interpretation and
    the :func:`delta` helper, not the routing arithmetic). Ties resolve by
    device id.

    Unlike JSQ/round-robin this sees *through* heterogeneity: a 3x-slower
    device inflates ``T_hat`` via both its drain time and its own service
    term, so the dispatcher prices the SLO impact of the placement, not just
    the queue length.
    """

    name = "stability-aware"

    def __init__(self, slo: float = 0.050, power_d: int = 2,
                 clip: float = DEFAULT_CLIP):
        assert power_d >= 1
        self.slo = float(slo)
        self.power_d = int(power_d)
        self.clip = float(clip)
        self._rng = np.random.default_rng(0xD15B)

    def reset(self, seed: int = 0) -> None:
        self._rng = np.random.default_rng(seed ^ 0xD15B)

    def delta(self, t_hat: float, deadline: Optional[float] = None) -> float:
        """The priced per-device stability-score delta f(T_hat) — what the
        argmin below minimises (via the monotone shortcut on T_hat)."""
        tau = self.slo if deadline is None else deadline
        return float(urgency_np(np.asarray(t_hat), tau, self.clip))

    def pick(self, model, eligible, view, deadline=None):
        k = min(self.power_d, len(eligible))
        if k == len(eligible):
            sample = list(eligible)
        else:
            idx = self._rng.choice(len(eligible), size=k, replace=False)
            sample = [eligible[int(i)] for i in sorted(idx)]
        # argmin of the stability delta == argmin of predicted completion
        # (f monotone for one tau); ties break toward the lower device id.
        return min(sample,
                   key=lambda d: (view.predicted_completion(d, model), d))


DISPATCHERS: Dict[str, Callable[..., Dispatcher]] = {
    "round-robin": RoundRobinDispatcher,
    "jsq": JoinShortestQueueDispatcher,
    "least-loaded": LeastLoadedDispatcher,
    "stability-aware": StabilityAwareDispatcher,
}


def make_dispatcher(name: str, slo: float = 0.050, power_d: int = 2,
                    clip: float = DEFAULT_CLIP) -> Dispatcher:
    """Policy factory (the dispatcher twin of ``make_scheduler``)."""
    try:
        cls = DISPATCHERS[name]
    except KeyError:
        raise ValueError(
            f"unknown dispatcher {name!r}; available: {sorted(DISPATCHERS)}"
        ) from None
    if cls is StabilityAwareDispatcher:
        return StabilityAwareDispatcher(slo=slo, power_d=power_d, clip=clip)
    return cls()


# ---------------------------------------------------------------------------
# Fleet construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One device in a cluster.

    Attributes:
      table:   the device's own execution :class:`ProfileTable` (heterogeneous
               fleets mix differently-scaled tables).
      name:    display name (defaults to the table's platform).
      models:  placement map — global model indices this device hosts;
               ``None`` = full replication (hosts every model).
      fail_at: optional wall-clock time (seconds) at which the device dies
               mid-run (see module docstring for the failover semantics).
      drift:   optional per-device ground-truth drift on true service times
               (``repro_torch.core.adaptive.DriftModel``); re-seeded per run from
               the cluster seed and the device id, so fleets drift
               independently but deterministically.
    """

    table: ProfileTable
    name: str = ""
    models: Optional[Tuple[int, ...]] = None
    fail_at: Optional[float] = None
    drift: Optional[DriftModel] = None

    def label(self, d: int) -> str:
        return self.name or self.table.meta.get("platform", f"device{d}")


def _homogeneous(size: int, base: ProfileTable) -> List[DeviceSpec]:
    return [DeviceSpec(base, name=f"dev{d}") for d in range(size)]


def _heterogeneous(size: int, base: ProfileTable) -> List[DeviceSpec]:
    """Alternate full-speed and Jetson-class (3.2x latency-scaled) devices,
    starting fast — the paper's RTX 3080 : GTX 1650 platform gap (Sec. VI-G).
    """
    slow = base.scaled(3.2, "jetson-class")
    return [
        DeviceSpec(base if d % 2 == 0 else slow,
                   name=f"dev{d}-{'fast' if d % 2 == 0 else 'slow'}")
        for d in range(size)
    ]


FLEETS: Dict[str, Callable[[int, ProfileTable], List[DeviceSpec]]] = {
    "homogeneous": _homogeneous,
    "heterogeneous": _heterogeneous,
}


def make_fleet(name: str, size: int, base: ProfileTable,
               fail_at: Sequence[Tuple[int, float]] = (),
               drift: Sequence[Tuple[int, DriftModel]] = ()) -> List[DeviceSpec]:
    """Build a named fleet of ``size`` devices from a base table;
    ``fail_at`` is an optional ``[(device, time)]`` failure schedule and
    ``drift`` an optional ``[(device, DriftModel)]`` drift assignment
    (give each device its *own* model instance — burst caches are
    per-instance; the simulator re-seeds them per device at run start)."""
    try:
        fleet_fn = FLEETS[name]
    except KeyError:
        raise ValueError(
            f"unknown fleet {name!r}; available: {sorted(FLEETS)}"
        ) from None
    assert size >= 1
    devices = fleet_fn(size, base)
    for d, t in fail_at:
        assert 0 <= d < size, f"fail_at device {d} outside fleet of {size}"
        devices[d] = dataclasses.replace(devices[d], fail_at=float(t))
    for d, dm in drift:
        assert 0 <= d < size, f"drift device {d} outside fleet of {size}"
        devices[d] = dataclasses.replace(devices[d], drift=dm)
    return devices


# ---------------------------------------------------------------------------
# The cluster simulator
# ---------------------------------------------------------------------------


class _Device:
    """One device's serving engine: per-round semantics mirror
    ``ServingSimulator.run`` exactly (snapshot -> prune -> decide -> occupy),
    driven by the cluster's global event loop instead of a private clock."""

    __slots__ = (
        "spec", "scheduler", "table", "queues", "rng", "noise_cov",
        "completions", "busy_time", "dropped", "dispatched", "alive",
        "pending_at", "in_quantum", "clock", "done", "profiler",
    )

    def __init__(self, spec: DeviceSpec, scheduler: Scheduler,
                 num_models: int, rng: np.random.Generator,
                 noise_cov: float,
                 profiler: Optional["OnlineProfiler"] = None):
        self.spec = spec
        self.scheduler = scheduler
        self.table = spec.table
        self.queues = [ServiceQueue(m) for m in range(num_models)]
        self.rng = rng
        self.noise_cov = noise_cov
        self.profiler = profiler  # per-device online adaptation (optional)
        self.completions: List[Completion] = []
        self.busy_time = 0.0
        self.dropped = 0
        self.dispatched = 0
        self.alive = True
        self.pending_at: Optional[float] = None  # next scheduling-round time
        self.in_quantum = False  # pending_at is a quantum end (exact time)
        self.clock = 0.0         # last event time processed (for span)
        self.done = False        # passed the drain cap; never schedules again

    def queued(self) -> int:
        return sum(len(q) for q in self.queues)

    def service_time(self, m: int, e: int, batch: int, t: float = 0.0) -> float:
        base = self.table(m, e, batch)
        if self.spec.drift is not None:
            base *= self.spec.drift.multiplier(t)
        if self.noise_cov > 0:
            base *= service_noise_multiplier(self.rng, self.noise_cov)
        return base

    def poke(self, t: float) -> None:
        """An arrival landed at ``t`` while this device may be idle: make
        sure a scheduling round runs one ulp past ``t`` (the single-device
        simulator's idle-advance), unless one is already due earlier or a
        quantum is in flight (its end-round will see the queue)."""
        if self.done or not self.alive or self.in_quantum:
            return
        wake = np.nextafter(t, np.inf)
        if self.pending_at is None or wake < self.pending_at:
            self.pending_at = wake


@dataclasses.dataclass
class ClusterResult:
    """Aggregate + per-device outcome of one cluster experiment."""

    metrics: ServingMetrics          # per_device rollup populated
    completions: List[Completion]    # merged, sorted by (finish, req_id)
    span: float
    trace: Optional[Trace] = None    # telemetry timeline (tracer attached)

    @property
    def dispatch_counts(self) -> Tuple[int, ...]:
        """Requests routed per device (view over ``metrics.per_device``)."""
        return tuple(d.dispatched for d in self.metrics.per_device)


class ClusterSimulator(DeviceLoadView):
    """Deterministic discrete-event simulator for a G-device cluster.

    Every device runs its own scheduler instance (``policy`` via
    ``make_scheduler``) over its own profile table; the ``dispatcher``
    assigns each arrival to one device hosting its model at the arrival
    time, reading live fleet state through the :class:`DeviceLoadView`
    protocol this class implements.
    """

    def __init__(
        self,
        devices: Sequence[DeviceSpec],
        policy: str = "edgeserving",
        config: Optional[SchedulerConfig] = None,
        dispatcher: Optional[Dispatcher] = None,
        num_models: Optional[int] = None,
        service_noise_cov: float = 0.0,
        seed: int = 0,
        drain_cap: float = 600.0,
        adapt: Optional[AdaptConfig] = None,
        tracer: Optional[Tracer] = None,
    ):
        assert len(devices) >= 1
        self.specs = list(devices)
        self.config = config or SchedulerConfig()
        self.policy = policy
        self.dispatcher = dispatcher or LeastLoadedDispatcher()
        self.num_models = num_models or self.specs[0].table.num_models
        self.noise_cov = service_noise_cov
        self.seed = seed
        self.drain_cap = drain_cap
        # Per-device online adaptation: each device's completions feed its
        # own OnlineProfiler over its own table (None = static tables).
        self.adapt = adapt
        # Record-only telemetry; None (default) skips every branch. Records
        # carry the owning device id; failover/strand events land too.
        self.tracer = tracer
        # placement: model -> device ids hosting it
        self.placement: List[List[int]] = [
            [d for d, s in enumerate(self.specs)
             if s.models is None or m in s.models]
            for m in range(self.num_models)
        ]
        for m, hosts in enumerate(self.placement):
            assert hosts, f"model {m} is placed on no device"
        self._devs: List[_Device] = []
        self._now = 0.0

    # -- DeviceLoadView --------------------------------------------------------

    def healthy(self, d: int) -> bool:
        return self._devs[d].alive

    def effective_backlog(self, d: int) -> float:
        dev = self._devs[d]
        remaining = max(dev.pending_at - self._now, 0.0) if dev.in_quantum else 0.0
        return remaining + drain_estimate(dev.scheduler,
                                          [len(q) for q in dev.queues])

    def total_queued(self, d: int) -> int:
        return self._devs[d].queued()

    def predicted_completion(self, d: int, model: int) -> float:
        # Price with the device's *current belief* (its scheduler's table),
        # not the cold-start spec table: under online adaptation the drain
        # term already reads the refreshed table via drain_estimate, and a
        # throttled device must advertise its learned slowdown to the
        # dispatcher too. Without adaptation both tables are one object.
        dev = self._devs[d]
        belief = dev.scheduler.table
        e_final = belief.num_exits - 1
        return self.effective_backlog(d) + belief(model, e_final, 1)

    # -- event loop ------------------------------------------------------------

    def run(
        self,
        arrivals: List[Request],
        horizon: float,
        warmup_tasks: int = 100,
    ) -> ClusterResult:
        # fresh per-run state (devices, dispatcher, rngs, drift, profilers):
        # run() is rerunnable
        for d, spec in enumerate(self.specs):
            if spec.drift is not None:
                spec.drift.reset((self.seed + 7919 * d) ^ 0xD21F)
        self._devs = [
            _Device(
                spec,
                make_scheduler(self.policy, spec.table, self.config),
                self.num_models,
                np.random.default_rng((self.seed + 7919 * d) ^ 0x5EED),
                self.noise_cov,
                profiler=make_profiler(spec.table, self.adapt),
            )
            for d, spec in enumerate(self.specs)
        ]
        self.dispatcher.reset(self.seed)
        self._now = 0.0
        if self.tracer is not None:
            self.tracer.reset()  # rerun-determinism, like the RNG re-seeds
        fails = sorted(
            (s.fail_at, d) for d, s in enumerate(self.specs)
            if s.fail_at is not None
        )
        fi = 0
        ai = 0
        n_arr = len(arrivals)
        lost = 0  # stranded: no surviving host for the model
        cap_t = horizon + self.drain_cap

        while True:
            # next event: (time, kind, idx); kind order at equal time is
            # failure(0) < arrival(1) < device-round(2) — arrivals must be
            # visible to a round at the same timestamp (ingest uses <= t).
            best = None
            if fi < len(fails):
                best = (fails[fi][0], 0, fails[fi][1])
            if ai < n_arr:
                ev = (arrivals[ai].arrival, 1, ai)
                if best is None or ev < best:
                    best = ev
            for d, dev in enumerate(self._devs):
                if dev.pending_at is not None:
                    ev = (dev.pending_at, 2, d)
                    if best is None or ev < best:
                        best = ev
            if best is None:
                break
            t, kind, idx = best
            self._now = t
            if kind == 0:
                fi += 1
                lost += self._fail(idx, t)
            elif kind == 1:
                ai += 1
                lost += self._dispatch(arrivals[idx], t)
            else:
                self._round(idx, t, cap_t)

        # -- rollup -----------------------------------------------------------
        merged = sorted(
            (c for dev in self._devs for c in dev.completions),
            key=lambda c: (c.finish, c.req_id),
        )
        owner = {}
        for d, dev in enumerate(self._devs):
            for c in dev.completions:
                owner[c.req_id] = d
        span = max(max((dev.clock for dev in self._devs), default=0.0), horizon)
        residual = (
            sum(dev.queued() for dev in self._devs) + (n_arr - ai) + lost
        )
        dropped = sum(dev.dropped for dev in self._devs)
        busy = sum(dev.busy_time for dev in self._devs)
        metrics = summarize(
            merged,
            self.specs[0].table,  # accuracy A(m, e) is model-intrinsic
            self.config.slo,
            warmup_tasks=warmup_tasks,
            busy_time=busy,
            span=span,
            residual_queue=residual,
            dropped=dropped,
        )
        metrics = dataclasses.replace(
            metrics,
            utilization=(busy / (span * len(self._devs))) if span > 0 else 0.0,
            per_device=self._per_device(merged, owner, metrics.warmup_used, span),
        )
        trace = None
        if self.tracer is not None:
            for d, dev in enumerate(self._devs):  # still queued at run end
                for q in dev.queues:
                    for req in q.pending():
                        self.tracer.record_residual(
                            req, self.config.slo, device=d)
            for req in arrivals[ai:]:  # never ingested (past the drain cap)
                self.tracer.record_residual(req, self.config.slo, device=-1)
            trace = self.tracer.freeze(
                engine="cluster", num_models=self.num_models,
                num_devices=len(self._devs), slo=self.config.slo,
                horizon=horizon, span=span,
                warmup_used=metrics.warmup_used, n_arrivals=n_arr)
        return ClusterResult(metrics=metrics, completions=merged, span=span,
                             trace=trace)

    # -- event handlers --------------------------------------------------------

    def _eligible(self, model: int) -> List[int]:
        return [d for d in self.placement[model] if self._devs[d].alive]

    def _dispatch(self, req: Request, t: float) -> int:
        """Route one request; returns 1 if it stranded (no live host)."""
        eligible = self._eligible(req.model)
        if not eligible:
            if self.tracer is not None:  # stranded = residual, no device
                self.tracer.record_residual(req, self.config.slo, device=-1)
            return 1
        d = eligible[0] if len(eligible) == 1 else self.dispatcher.pick(
            req.model, eligible, self, deadline=req.deadline)
        dev = self._devs[d]
        dev.queues[req.model].push(req)
        dev.dispatched += 1
        dev.poke(t)
        return 0

    def _fail(self, d: int, t: float) -> int:
        """Kill device ``d``; failover its queue. Returns stranded count."""
        # No clock bump: the clock tracks serving activity for the span /
        # throughput denominators, and an idle death occupies no time (a
        # mid-quantum one gets its clock from the quantum-end round).
        dev = self._devs[d]
        dev.alive = False
        if not dev.in_quantum:
            dev.pending_at = None  # cancel any idle wake; in-flight quantum
            # (if any) still completes and its end-round goes dormant.
        orphans: List[Request] = []
        for q in dev.queues:
            orphans.extend(q.pop_batch(len(q)))
        orphans.sort(key=lambda r: (r.arrival, r.req_id))
        if self.tracer is not None:
            self.tracer.record_event(t, "device-failure", device=d,
                                     orphans=len(orphans))
        stranded = sum(self._dispatch(r, t) for r in orphans)
        if self.tracer is not None:
            self.tracer.record_event(
                t, "failover", device=d,
                requeued=len(orphans) - stranded, stranded=stranded)
        return stranded

    def _round(self, d: int, t: float, cap_t: float) -> None:
        """One scheduling round on device ``d`` at time ``t`` — the body of
        ``ServingSimulator.run``'s while-loop, minus the clock bookkeeping
        the global event loop now owns."""
        dev = self._devs[d]
        dev.pending_at = None
        ending_quantum, dev.in_quantum = dev.in_quantum, False
        dev.clock = max(dev.clock, t)
        if dev.done or (ending_quantum and not dev.alive):
            return
        if t > cap_t:
            dev.done = True
            return
        tracer = self.tracer
        snapshot = QueueSnapshot.take(dev.queues, t)
        shed = dev.scheduler.prune(snapshot)
        if shed:
            n_shed = 0
            for m, n in shed:
                popped = dev.queues[m].pop_batch(n)
                n_shed += len(popped)
                if tracer is not None:
                    for req in popped:
                        tracer.record_drop(req, t, self.config.slo, device=d)
            dev.dropped += n_shed
            if dev.profiler is not None:
                dev.profiler.observe_dropped(n_shed)
            if tracer is not None and n_shed:
                tracer.record_event(t, "shed", device=d, n=n_shed)
            snapshot = QueueSnapshot.take(dev.queues, t)
        decision = dev.scheduler.decide(snapshot)
        if decision is None:
            # Idle. Arrivals poke the device themselves; the only wake the
            # device must self-schedule is a deferred-batching due time.
            if dev.queued() and hasattr(dev.scheduler, "next_wake"):
                wake = dev.scheduler.next_wake(snapshot)
                if wake is not None:
                    dev.pending_at = np.nextafter(max(t, wake), np.inf)
            return
        service = dev.service_time(decision.model, decision.exit_idx,
                                   decision.batch_size, t)
        batch = dev.queues[decision.model].pop_batch(decision.batch_size)
        assert len(batch) == decision.batch_size, "scheduler overdrew queue"
        t_end = t + service
        dev.busy_time += service
        for req in batch:
            dev.completions.append(Completion(
                req_id=req.req_id,
                model=req.model,
                arrival=req.arrival,
                dispatch=t,
                finish=t_end,
                exit_idx=decision.exit_idx,
                batch_size=decision.batch_size,
                deadline=req.deadline,
            ))
        if tracer is not None:
            tracer.record_decision(
                t, decision, t_end,
                tuple(snapshot.qlens()),
                tuple(snapshot.w_max(m) for m in range(self.num_models)),
                margin=decision_margin(dev.scheduler, snapshot),
                device=d,
            )
            for req in batch:
                tracer.record_completion(
                    req, t, t_end, decision.exit_idx, decision.batch_size,
                    self.config.slo, device=d)
        if dev.profiler is not None:
            refreshed = dev.profiler.ingest_quantum(
                decision.model, decision.exit_idx, decision.batch_size,
                service, t_end, batch, self.config.slo)
            if refreshed is not None:
                dev.scheduler.table = refreshed
                if tracer is not None:
                    tracer.record_refresh(t_end, dev.profiler, device=d)
        dev.pending_at = t_end
        dev.in_quantum = True

    # -- per-device rollup -----------------------------------------------------

    def _per_device(
        self,
        merged: List[Completion],
        owner: Dict[int, int],
        warmup_used: int,
        span: float,
    ) -> Tuple[DeviceMetrics, ...]:
        done = merged[warmup_used:]
        out = []
        for d, dev in enumerate(self._devs):
            mine = [c for c in done if owner[c.req_id] == d]
            # One summarize() per device (warmup already taken globally):
            # the violation / P95 / exit-depth rules stay written once, so
            # the rollup cannot drift from the aggregate's accounting.
            dm = summarize(mine, dev.table, self.config.slo, warmup_tasks=0,
                           dropped=dev.dropped)
            out.append(DeviceMetrics(
                device=d,
                name=dev.spec.label(d),
                num_completed=len(mine),
                dispatched=dev.dispatched,
                dropped=dev.dropped,
                violation_ratio=dm.violation_ratio,
                p95_latency=dm.p95_latency,
                mean_exit_depth=dm.mean_exit_depth,
                utilization=float(dev.busy_time / span) if span > 0 else 0.0,
                alive=dev.alive,
            ))
        return tuple(out)
