"""Workload scenarios: arrival-process generators beyond stationary Poisson.

The paper evaluates EdgeServing only under stationary Poisson arrivals with a
single global SLO (Sec. VI-A). This module gives a common
:class:`ArrivalProcess` interface and five generators, the reference's
(``src/repro/core/workloads.py``):

  * :class:`PoissonProcess`    — the paper's stationary default;
  * :class:`MMPPProcess`       — two-state Markov-modulated Poisson (on-off
    bursts, mean rate preserved);
  * :class:`DiurnalProcess`    — sinusoid-modulated rate (day/night cycle,
    compressed to simulation timescales);
  * :class:`FlashCrowdProcess` — a flash-crowd spike multiplying the rate of
    selected models inside a window;
  * :class:`TraceReplayProcess`— deterministic replay of a recorded trace
    (round-trips through :func:`record_trace`).

Every generator is seed-deterministic and host numpy: the draws are the
reference's ``np.random.Generator`` calls in the reference's order, so a
trace for a given seed is bitwise the reference's. Each emits
:class:`~repro_torch.core.request.Request` records sorted by arrival time
with monotone ``req_id``, and can stamp a per-queue SLO vector onto
``Request.deadline`` so heterogeneous deadlines flow end to end through
snapshot urgency, Eq. 6 and violation accounting. ``generate_columns``
gives the same trace as :class:`TraceColumns`, the compiled scan tiers'
native format (``repro_torch.core.simfast`` / ``clusterfast``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Request

__all__ = [
    "ArrivalProcess",
    "PoissonProcess",
    "MMPPProcess",
    "DiurnalProcess",
    "FlashCrowdProcess",
    "TraceColumns",
    "TraceReplayProcess",
    "SCENARIOS",
    "columns_from_requests",
    "make_scenario",
    "record_trace",
    "interarrival_cov",
    "burstiness_index",
]


# ---------------------------------------------------------------------------
# Columnar traces (the scan engines' native format)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceColumns:
    """One arrival trace as columnar arrays instead of ``Request`` objects.

    The compiled scan engines flatten a ``Request`` lane straight back into
    arrays, so for thousand-seed bands the per-request Python objects are
    pure overhead. ``ArrivalProcess.generate_columns`` produces this form
    directly; ``repro_torch.core.simfast`` / ``clusterfast`` accept it
    wherever a ``Request`` lane is accepted, with bitwise-identical results
    (``req_id`` is the row index, exactly ``generate()``'s numbering).
    Indexing materialises single ``Request`` objects on demand, so
    completion-keeping paths keep working.
    """

    arrival: np.ndarray             # [n] float64, sorted ascending
    model: np.ndarray               # [n] int64 queue index
    data_id: np.ndarray             # [n] int64
    deadline: Optional[np.ndarray]  # [n] float64, NaN = no deadline; or None

    def __len__(self) -> int:
        return len(self.model)

    def __getitem__(self, i: int) -> Request:
        dl = None
        if self.deadline is not None:
            d = self.deadline[i]
            dl = None if np.isnan(d) else float(d)
        return Request(
            req_id=int(i),
            model=int(self.model[i]),
            arrival=float(self.arrival[i]),
            data_id=int(self.data_id[i]),
            deadline=dl,
        )

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def columns_from_requests(requests: Sequence[Request]) -> TraceColumns:
    """Columnar view of an existing ``Request`` lane (shared fallback)."""
    n = len(requests)
    arrival = np.fromiter(
        (r.arrival for r in requests), dtype=np.float64, count=n)
    model = np.fromiter((r.model for r in requests), dtype=np.int64, count=n)
    data = np.fromiter(
        (r.data_id for r in requests), dtype=np.int64, count=n)
    if all(r.deadline is None for r in requests):
        deadline = None
    else:
        deadline = np.fromiter(
            (np.nan if r.deadline is None else r.deadline for r in requests),
            dtype=np.float64, count=n,
        )
    return TraceColumns(arrival=arrival, model=model, data_id=data,
                        deadline=deadline)


# ---------------------------------------------------------------------------
# Interface
# ---------------------------------------------------------------------------


class ArrivalProcess:
    """Seed-deterministic generator of a merged, time-sorted Request trace.

    Args:
      rates:     per-model *mean* arrival rates (req/s); zero-rate models
                 receive no traffic.
      deadlines: optional per-model SLO vector (seconds); stamped onto each
                 generated request's ``deadline``. ``None`` keeps the global
                 SLO fallback (the paper's setting).
    """

    name = "base"

    def __init__(
        self,
        rates: Sequence[float],
        deadlines: Optional[Sequence[float]] = None,
    ):
        self.rates = [float(r) for r in rates]
        if deadlines is not None:
            deadlines = [float(d) for d in deadlines]
            assert len(deadlines) == len(self.rates), (
                "deadlines must give one SLO per model"
            )
        self.deadlines = deadlines

    @property
    def num_models(self) -> int:
        return len(self.rates)

    def mean_rate(self, m: int) -> float:
        """Long-run mean arrival rate of model ``m`` (req/s)."""
        return self.rates[m]

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        """Arrivals in ``[0, horizon)``, time-sorted, ``req_id`` monotone."""
        raise NotImplementedError

    def generate_columns(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> TraceColumns:
        """The same trace as :meth:`generate`, as :class:`TraceColumns`.

        Bitwise-identical to columnising ``generate()``'s output — same
        RNG draws, same sort order — but skips ``Request``
        materialisation and the Python tuple sort. Processes that build
        their trace some other way than ``_event_tuples`` fall back
        through ``generate()``.
        """
        events = self._event_tuples(horizon, seed, data_pool)
        if events is None:
            return columns_from_requests(
                self.generate(horizon, seed=seed, data_pool=data_pool))
        return self._finalize_columns(events)

    # -- shared assembly ----------------------------------------------------

    def _event_tuples(
        self, horizon: float, seed: int, data_pool: int
    ) -> Optional[List[tuple]]:
        """Unsorted ``[(t, m, data_id)]`` events, or None if the subclass
        assembles requests directly (column generation then falls back)."""
        return None

    def _finalize_columns(self, events: List[tuple]) -> TraceColumns:
        """Columnar counterpart of :meth:`_finalize`: ``lexsort`` on
        ``(t, m, data_id)`` reproduces the tuple sort order exactly."""
        n = len(events)
        t = np.fromiter((e[0] for e in events), dtype=np.float64, count=n)
        m = np.fromiter((e[1] for e in events), dtype=np.int64, count=n)
        d = np.fromiter((e[2] for e in events), dtype=np.int64, count=n)
        order = np.lexsort((d, m, t))
        t, m, d = t[order], m[order], d[order]
        dl = self.deadlines
        deadline = (
            None if dl is None
            else np.asarray(dl, dtype=np.float64)[m]
        )
        return TraceColumns(arrival=t, model=m, data_id=d, deadline=deadline)

    def _finalize(self, events: List[tuple]) -> List[Request]:
        """``[(t, m, data_id)]`` -> sorted Request list with deadlines."""
        events.sort()
        dl = self.deadlines
        return [
            Request(
                req_id=i,
                model=m,
                arrival=t,
                data_id=int(d),
                deadline=None if dl is None else dl[m],
            )
            for i, (t, m, d) in enumerate(events)
        ]

    def _piecewise_events(
        self,
        rng: np.random.Generator,
        segments: Sequence[Tuple[float, float, float]],
        data_pool: int,
    ) -> List[tuple]:
        """Poisson events under a piecewise-constant rate multiplier.

        ``segments`` is ``[(t0, t1, mult)]`` covering the horizon; within each
        segment model ``m`` arrives as Poisson at ``rates[m] * mult`` (count ~
        Poisson(rate*dur), times i.i.d. uniform — the standard construction).
        """
        events: List[tuple] = []
        for m, lam in enumerate(self.rates):
            if lam > 0:
                events.extend(
                    _segment_poisson(rng, m, lam, segments, data_pool)
                )
        return events


def _segment_poisson(
    rng: np.random.Generator,
    model: int,
    lam: float,
    segments: Sequence[Tuple[float, float, float]],
    data_pool: int,
) -> List[tuple]:
    """One model's ``(t, model, data_id)`` events over rate segments."""
    events: List[tuple] = []
    for t0, t1, mult in segments:
        dur = t1 - t0
        if dur <= 0 or mult <= 0:
            continue
        n = int(rng.poisson(lam * mult * dur))
        times = rng.uniform(t0, t1, size=n)
        data = rng.integers(0, data_pool, size=n)
        events.extend(zip(times.tolist(), [model] * n, data.tolist()))
    return events


class PoissonProcess(ArrivalProcess):
    """Stationary independent Poisson arrivals per model (the paper default):
    exponential gaps, vectorised with slack then trimmed."""

    name = "poisson"

    def _event_tuples(
        self, horizon: float, seed: int, data_pool: int
    ) -> List[tuple]:
        rng = np.random.default_rng(seed)
        events: List[tuple] = []
        for m, lam in enumerate(self.rates):
            if lam <= 0:
                continue
            # Expected count + slack, then trim: cheaper than a Python loop.
            n_expect = int(lam * horizon * 1.25 + 50)
            gaps = rng.exponential(1.0 / lam, size=n_expect)
            times = np.cumsum(gaps)
            while times[-1] < horizon:  # extremely unlikely; extend defensively
                extra = rng.exponential(1.0 / lam, size=n_expect)
                times = np.concatenate([times, times[-1] + np.cumsum(extra)])
            times = times[times < horizon]
            data = rng.integers(0, data_pool, size=len(times))
            events.extend(zip(times.tolist(), [m] * len(times), data.tolist()))
        return events

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        return self._finalize(self._event_tuples(horizon, seed, data_pool))


# ---------------------------------------------------------------------------
# MMPP: two-state on-off bursts
# ---------------------------------------------------------------------------


class MMPPProcess(ArrivalProcess):
    """Two-state Markov-modulated Poisson process (bursty on-off traffic).

    A single modulating chain (shared by all models, so bursts hit every
    queue together — the hard case for a multi-queue scheduler) alternates
    between ON and OFF states with exponential holding times. In the ON
    state every rate is multiplied by ``burst``; the OFF multiplier is
    derived so the long-run mean rate equals ``rates``:

        duty * burst + (1 - duty) * off = 1
        =>  off = (1 - duty * burst) / (1 - duty)      (requires duty*burst <= 1)

    Args:
      burst: ON-state rate multiplier (> 1).
      duty:  long-run fraction of time spent ON.
      cycle: mean ON+OFF cycle length in seconds (mean ON holding time is
             ``duty * cycle``, mean OFF is ``(1 - duty) * cycle``).
    """

    name = "mmpp"

    def __init__(
        self,
        rates: Sequence[float],
        burst: float = 3.0,
        duty: float = 0.25,
        cycle: float = 2.0,
        deadlines: Optional[Sequence[float]] = None,
    ):
        super().__init__(rates, deadlines)
        assert burst >= 1.0 and 0.0 < duty < 1.0 and cycle > 0.0
        assert burst * duty <= 1.0, (
            "mean-preserving OFF rate would be negative: need burst*duty <= 1"
        )
        self.burst = float(burst)
        self.duty = float(duty)
        self.cycle = float(cycle)
        self.off = (1.0 - self.duty * self.burst) / (1.0 - self.duty)

    def _segments(
        self, rng: np.random.Generator, horizon: float
    ) -> List[Tuple[float, float, float]]:
        segs: List[Tuple[float, float, float]] = []
        t = 0.0
        on = bool(rng.random() < self.duty)  # stationary start state
        while t < horizon:
            mean = self.duty * self.cycle if on else (1.0 - self.duty) * self.cycle
            dur = float(rng.exponential(mean))
            segs.append((t, min(t + dur, horizon), self.burst if on else self.off))
            t += dur
            on = not on
        return segs

    def _event_tuples(
        self, horizon: float, seed: int, data_pool: int
    ) -> List[tuple]:
        rng = np.random.default_rng(seed)
        segs = self._segments(rng, horizon)
        return self._piecewise_events(rng, segs, data_pool)

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        return self._finalize(self._event_tuples(horizon, seed, data_pool))


# ---------------------------------------------------------------------------
# Diurnal: sinusoid-modulated rate
# ---------------------------------------------------------------------------


class DiurnalProcess(ArrivalProcess):
    """Sinusoid-modulated Poisson (a day/night cycle at simulation scale).

        rate_m(t) = rates[m] * (1 + depth * sin(2π t / period + phase))

    Generated by thinning (Lewis & Shedler): homogeneous candidates at the
    peak rate ``rates[m] * (1 + depth)``, each accepted with probability
    ``rate_m(t) / peak``. The long-run mean over whole periods is ``rates``.

    Args:
      period: modulation period in seconds (paper horizons are ~10-20 s, so
              the default compresses a "day" into 10 s).
      depth:  modulation depth in [0, 1); 0 degenerates to Poisson.
      phase:  phase offset in radians (models share one phase: load peaks
              together, like evening traffic).
    """

    name = "diurnal"

    def __init__(
        self,
        rates: Sequence[float],
        period: float = 10.0,
        depth: float = 0.8,
        phase: float = -math.pi / 2,  # start at the trough: ramp up, peak, ramp down
        deadlines: Optional[Sequence[float]] = None,
    ):
        super().__init__(rates, deadlines)
        assert period > 0.0 and 0.0 <= depth < 1.0
        self.period = float(period)
        self.depth = float(depth)
        self.phase = float(phase)

    def _mult(self, t: np.ndarray) -> np.ndarray:
        return 1.0 + self.depth * np.sin(
            2.0 * math.pi * t / self.period + self.phase
        )

    def _event_tuples(
        self, horizon: float, seed: int, data_pool: int
    ) -> List[tuple]:
        rng = np.random.default_rng(seed)
        events: List[tuple] = []
        peak = 1.0 + self.depth
        for m, lam in enumerate(self.rates):
            if lam <= 0:
                continue
            n_cand = int(rng.poisson(lam * peak * horizon))
            cand = rng.uniform(0.0, horizon, size=n_cand)
            accept = rng.random(n_cand) < self._mult(cand) / peak
            times = cand[accept]
            data = rng.integers(0, data_pool, size=len(times))
            events.extend(
                zip(times.tolist(), [m] * len(times), data.tolist())
            )
        return events

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        return self._finalize(self._event_tuples(horizon, seed, data_pool))


# ---------------------------------------------------------------------------
# Flash crowd: rate spike in a window
# ---------------------------------------------------------------------------


class FlashCrowdProcess(ArrivalProcess):
    """Baseline Poisson plus a flash-crowd spike (unforeseen surge).

    Inside ``[spike_start, spike_start + spike_duration)`` the rate of every
    spiked model is multiplied by ``magnitude``; outside it traffic is the
    stationary baseline. Unlike MMPP/diurnal the *mean* rate rises above
    ``rates`` — a flash crowd is extra load, not redistributed load.

    ``spike_start``/``spike_duration`` may be ``None`` to default to 40% and
    10% of the horizon at generate() time.

    Args:
      magnitude:    rate multiplier during the spike (>= 1).
      spike_models: model indices hit by the spike (default: all models —
                    a correlated crowd; pass e.g. ``(0,)`` for a one-queue
                    hotspot, the case that stresses cross-queue scheduling).
    """

    name = "flash-crowd"

    def __init__(
        self,
        rates: Sequence[float],
        spike_start: Optional[float] = None,
        spike_duration: Optional[float] = None,
        magnitude: float = 5.0,
        spike_models: Optional[Sequence[int]] = None,
        deadlines: Optional[Sequence[float]] = None,
    ):
        super().__init__(rates, deadlines)
        assert magnitude >= 1.0
        self.spike_start = spike_start
        self.spike_duration = spike_duration
        self.magnitude = float(magnitude)
        self.spike_models = (
            None if spike_models is None else tuple(int(m) for m in spike_models)
        )

    def _window(self, horizon: float) -> Tuple[float, float]:
        start = 0.4 * horizon if self.spike_start is None else self.spike_start
        dur = 0.1 * horizon if self.spike_duration is None else self.spike_duration
        return start, min(start + dur, horizon)

    def _event_tuples(
        self, horizon: float, seed: int, data_pool: int
    ) -> List[tuple]:
        rng = np.random.default_rng(seed)
        t0, t1 = self._window(horizon)
        spiked = (
            set(range(self.num_models))
            if self.spike_models is None
            else set(self.spike_models)
        )
        events: List[tuple] = []
        for m, lam in enumerate(self.rates):
            if lam <= 0:
                continue
            mag = self.magnitude if m in spiked else 1.0
            segs = [(0.0, t0, 1.0), (t0, t1, mag), (t1, horizon, 1.0)]
            events.extend(_segment_poisson(rng, m, lam, segs, data_pool))
        return events

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        return self._finalize(self._event_tuples(horizon, seed, data_pool))


# ---------------------------------------------------------------------------
# Trace replay
# ---------------------------------------------------------------------------


def record_trace(requests: Sequence[Request]) -> List[tuple]:
    """Serialize requests to plain ``(arrival, model, data_id, deadline)``
    tuples — JSON-friendly, and the exact inverse of replaying them."""
    return [(r.arrival, r.model, r.data_id, r.deadline) for r in requests]


class TraceReplayProcess(ArrivalProcess):
    """Deterministic replay of a recorded arrival trace.

    Construct from either an explicit ``trace`` (``record_trace`` output, or
    bare ``(arrival, model)`` pairs) or a ``source`` process whose generated
    trace is recorded and replayed through the serialization round-trip —
    proving the record/replay path end-to-end while behaving exactly like
    the source. Replay ignores entries at or past the horizon and numbers
    ``req_id`` afresh, sequentially in time order.

    Args:
      time_scale: multiply recorded timestamps (e.g. 0.5 compresses a trace
                  to double its arrival intensity).
    """

    name = "trace-replay"

    def __init__(
        self,
        trace: Optional[Sequence[tuple]] = None,
        source: Optional[ArrivalProcess] = None,
        time_scale: float = 1.0,
        deadlines: Optional[Sequence[float]] = None,
    ):
        assert (trace is None) != (source is None), (
            "exactly one of trace/source must be given"
        )
        if trace is not None:
            num_models = 1 + max((int(e[1]) for e in trace), default=0)
        else:
            num_models = source.num_models
        super().__init__([0.0] * num_models, deadlines)
        self.trace = None if trace is None else [tuple(e) for e in trace]
        self.source = source
        self.time_scale = float(time_scale)

    def mean_rate(self, m: int) -> float:
        if self.source is not None:
            return self.source.mean_rate(m) / self.time_scale
        return self.rates[m]  # unknown for bare traces

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        trace = self.trace
        if trace is None:
            inner = self.source.generate(
                horizon / self.time_scale, seed=seed, data_pool=data_pool
            )
            trace = record_trace(inner)
        dl = self.deadlines
        entries = []
        for e in trace:
            t = float(e[0]) * self.time_scale
            if t >= horizon:
                continue
            m = int(e[1])
            data = int(e[2]) if len(e) > 2 else 0
            deadline = e[3] if len(e) > 3 else None
            if deadline is None and dl is not None:
                deadline = dl[m]
            entries.append((t, m, data, deadline))
        entries.sort()
        return [
            Request(req_id=i, model=m, arrival=t, data_id=d, deadline=dead)
            for i, (t, m, d, dead) in enumerate(entries)
        ]


# ---------------------------------------------------------------------------
# Burstiness diagnostics
# ---------------------------------------------------------------------------


def interarrival_cov(requests: Sequence[Request], model: Optional[int] = None) -> float:
    """Coefficient of variation (std/mean) of interarrival times.

    1.0 for Poisson; > 1 for bursty (MMPP, flash-crowd) processes. Pass
    ``model`` to restrict to one queue's substream, else the merged trace.
    """
    times = np.array(
        [r.arrival for r in requests if model is None or r.model == model]
    )
    gaps = np.diff(times)
    if len(gaps) < 2 or gaps.mean() == 0:
        return 0.0
    return float(gaps.std() / gaps.mean())


def burstiness_index(requests: Sequence[Request], model: Optional[int] = None) -> float:
    """Squared interarrival CoV — the renewal-process burstiness index
    (1 = Poisson, > 1 = bursty, < 1 = regular)."""
    return interarrival_cov(requests, model) ** 2


# ---------------------------------------------------------------------------
# Scenario registry
# ---------------------------------------------------------------------------


def _replayed_mmpp(rates, deadlines=None, **kwargs) -> TraceReplayProcess:
    """The fig13 'trace-replay' scenario: record an MMPP trace and replay it
    through the serialization round-trip."""
    return TraceReplayProcess(
        source=MMPPProcess(rates, **kwargs), deadlines=deadlines
    )


SCENARIOS: Dict[str, Callable[..., ArrivalProcess]] = {
    "poisson": PoissonProcess,
    "mmpp": MMPPProcess,
    "diurnal": DiurnalProcess,
    "flash-crowd": FlashCrowdProcess,
    "trace-replay": _replayed_mmpp,
}


def make_scenario(
    name: str,
    rates: Sequence[float],
    deadlines: Optional[Sequence[float]] = None,
    **kwargs,
) -> ArrivalProcess:
    """Instantiate a registered scenario by name with per-model ``rates``
    (and optionally a per-model SLO vector + scenario-specific kwargs)."""
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None
    return factory(rates, deadlines=deadlines, **kwargs)
