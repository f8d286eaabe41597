"""Online profile adaptation under device drift (beyond paper Sec. IV).

The paper measures the L(m, e, B) table once, offline, and assumes it stays
valid for as long as the system serves (Sec. IV-B). Real edge devices drift:
thermal throttling ramps service times up, DVFS governors step clock
speeds, co-located workloads inject contention bursts. This module is the
port of the reference's ``src/repro/core/adaptive.py`` and has three pieces,
threaded through the simulator (``repro_torch.core.simulator``) and the
sweep harness (``repro_torch.core.sweep``):

  * :class:`OnlineProfiler` — maintains per-(m, e, B) EWMA-mean and
    streaming-P95 service-time estimates from observed batch completions and
    materialises refreshed :class:`~repro_torch.core.profile.ProfileTable`
    views on a configurable cadence, so the offline table becomes the
    *cold start* rather than the whole story.
  * The :class:`DriftModel` family — seed-deterministic ground-truth
    multipliers on *true* service time (thermal-throttle ramp, DVFS step
    change, contention interference bursts) so the execution environment
    can diverge from the table the scheduler decides with.
  * :class:`SafetyController` — adjusts the table's safety multiplier from
    observed violation headroom (the adaptive twin of the static
    ``ProfileTable.with_safety`` knob).

All of it is host numpy and Python floats, op for op the reference's, so a
run with drift and adaptation is bitwise the reference's; with both off the
serving path is bitwise the stock one.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.profile import ProfileTable

__all__ = [
    "AdaptConfig",
    "ContentionDrift",
    "DriftModel",
    "DRIFTS",
    "DVFSStepDrift",
    "OnlineProfiler",
    "SafetyController",
    "ThermalThrottleDrift",
    "make_drift",
    "make_profiler",
]


# ---------------------------------------------------------------------------
# Drift models: ground-truth service-time multipliers
# ---------------------------------------------------------------------------


class DriftModel:
    """Seed-deterministic multiplier on true service time at time ``t``.

    The simulator applies ``multiplier(t)`` to the execution table's
    latency at each quantum's dispatch time — the *scheduler* never sees it
    directly; it can only observe the inflated completions (which is what
    :class:`OnlineProfiler` adapts from). ``multiplier`` must be a
    deterministic function of ``(seed, t)`` regardless of query order, so
    sweeps stay parallel ≡ serial bitwise.
    """

    name = "base"

    def reset(self, seed: int = 0) -> None:
        """Re-seed any internal randomness; deterministic models no-op."""

    def multiplier(self, t: float) -> float:
        """True-service multiplier at wall-clock time ``t`` (≥ some ε > 0)."""
        raise NotImplementedError


class ThermalThrottleDrift(DriftModel):
    """Thermal-throttle ramp: 1.0 until ``onset``, then a linear ramp to
    ``peak`` over ``ramp`` seconds, flat afterwards (sustained-load edge
    boards; cf. He et al. Sec. II measurement of Jetson throttling)."""

    name = "thermal-throttle"

    def __init__(self, onset: float = 2.0, ramp: float = 3.0,
                 peak: float = 2.0):
        assert ramp > 0 and peak > 0
        self.onset = float(onset)
        self.ramp = float(ramp)
        self.peak = float(peak)

    def multiplier(self, t: float) -> float:
        if t <= self.onset:
            return 1.0
        frac = min((t - self.onset) / self.ramp, 1.0)
        return 1.0 + (self.peak - 1.0) * frac


class DVFSStepDrift(DriftModel):
    """DVFS step changes: piecewise-constant multiplier, 1.0 before the
    first step; each ``(time, factor)`` step holds until the next."""

    name = "dvfs-step"

    def __init__(self, steps: Tuple[Tuple[float, float], ...] = ((3.0, 1.6),)):
        steps = tuple((float(t), float(f)) for t, f in steps)
        assert all(f > 0 for _, f in steps)
        self.steps = tuple(sorted(steps))
        self._times = [t for t, _ in self.steps]

    def multiplier(self, t: float) -> float:
        i = bisect.bisect_right(self._times, t)
        return 1.0 if i == 0 else self.steps[i - 1][1]


class ContentionDrift(DriftModel):
    """Co-located contention: seed-deterministic interference bursts.

    Burst start gaps are exponential with mean ``1 / burst_rate``; each
    burst lasts ``burst_duration`` seconds and multiplies service time by
    ``magnitude``. Windows are generated lazily from the seeded RNG in time
    order and cached, so ``multiplier(t)`` is a pure function of
    ``(seed, t)`` no matter the query order.
    """

    name = "contention"

    def __init__(self, burst_rate: float = 0.25, burst_duration: float = 1.0,
                 magnitude: float = 2.0, seed: int = 0):
        assert burst_rate > 0 and burst_duration > 0 and magnitude > 0
        self.burst_rate = float(burst_rate)
        self.burst_duration = float(burst_duration)
        self.magnitude = float(magnitude)
        self.reset(seed)

    def reset(self, seed: int = 0) -> None:
        self._rng = np.random.default_rng(seed ^ 0xD21F7)
        self._starts: list = []   # burst start times, ascending
        self._frontier = 0.0      # windows generated up to here

    def _extend(self, upto: float) -> None:
        while self._frontier <= upto:
            gap = float(self._rng.exponential(1.0 / self.burst_rate))
            start = self._frontier + gap
            self._starts.append(start)
            self._frontier = start + self.burst_duration
        # ``_frontier`` always sits at the end of the last generated burst,
        # so every t below it is classified from cached windows only.

    def multiplier(self, t: float) -> float:
        self._extend(t)
        i = bisect.bisect_right(self._starts, t)
        if i and t < self._starts[i - 1] + self.burst_duration:
            return self.magnitude
        return 1.0


DRIFTS: Dict[str, Callable[..., DriftModel]] = {
    "thermal-throttle": ThermalThrottleDrift,
    "dvfs-step": DVFSStepDrift,
    "contention": ContentionDrift,
}


def make_drift(name: Optional[str], **kwargs) -> Optional[DriftModel]:
    """Drift-model factory (the drift twin of ``make_scheduler``).

    ``None`` / ``"none"`` return ``None`` — the stock, drift-free serving
    path, guaranteed bitwise-identical to the pre-adaptation code.
    """
    if name is None or name == "none":
        assert not kwargs, "drift kwargs given without a drift model"
        return None
    try:
        cls = DRIFTS[name]
    except KeyError:
        raise ValueError(
            f"unknown drift model {name!r}; available: "
            f"{sorted(DRIFTS) + ['none']}"
        ) from None
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Safety controller: violation-headroom feedback on the safety multiplier
# ---------------------------------------------------------------------------


class SafetyController:
    """Adaptive safety multiplier from observed violation headroom.

    The static path picks a fixed P95-style multiplier once
    (``ProfileTable.with_safety``, ``from_roofline(safety=...)``); this
    controller closes the loop instead: it tracks an EWMA of the violation
    indicator over completed requests and nudges the multiplier up
    (multiplicative increase, capped at ``max_mult``) while violations run
    above ``target``, decaying it back toward ``min_mult`` when observed
    headroom shows the table is already conservative enough. Deterministic:
    the multiplier is a pure fold over the observation stream.
    """

    def __init__(self, target: float = 0.01, alpha: float = 0.05,
                 up: float = 1.02, down: float = 1.005,
                 min_mult: float = 1.0, max_mult: float = 1.5):
        assert 0 < alpha <= 1 and up >= 1 and down >= 1
        assert 0 < min_mult <= max_mult
        self.target = float(target)
        self.alpha = float(alpha)
        self.up = float(up)
        self.down = float(down)
        self.min_mult = float(min_mult)
        self.max_mult = float(max_mult)
        self.multiplier = float(min_mult)
        self.violation_ewma = 0.0
        self.num_observed = 0

    def observe(self, latency: float, deadline: float) -> None:
        """Fold one completion's (total latency, effective deadline) in."""
        self._fold(latency > deadline)

    def observe_violation(self) -> None:
        """Fold one certain violation (a shed/dropped request — the metrics
        layer counts every drop as a violation, so the controller must)."""
        self._fold(True)

    def _fold(self, late: bool) -> None:
        self.violation_ewma += self.alpha * (
            (1.0 if late else 0.0) - self.violation_ewma)
        self.num_observed += 1
        if self.violation_ewma > self.target:
            self.multiplier = min(self.multiplier * self.up, self.max_mult)
        elif self.violation_ewma < 0.5 * self.target:
            self.multiplier = max(self.multiplier / self.down, self.min_mult)


# ---------------------------------------------------------------------------
# Online profiler: streaming per-cell estimates -> refreshed ProfileTables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Knobs for online profile adaptation (hashable: rides in SweepSpec).

    Attributes:
      alpha:         EWMA smoothing for the per-cell mean and the global
                     drift-ratio estimate.
      window:        streaming-P95 window (samples kept per (m, e, B) cell).
      refresh_every: cadence (seconds of serving time) between materialised
                     table refreshes handed to the scheduler.
      mode:          which estimate the refreshed table carries per observed
                     cell: ``"p95"`` (window percentile; the paper's offline
                     profiler records P95 too) or ``"mean"`` (EWMA).
      min_samples:   observations a cell needs before its estimate replaces
                     the cold-start value.
      propagate:     scale *unobserved* cells by the global EWMA drift ratio
                     (observed / cold-start); device-wide drift like thermal
                     throttling then reaches cells the scheduler rarely runs.
      safety:        enable the :class:`SafetyController` feedback loop on
                     the materialised table's safety multiplier.
      safety_target: the controller's violation-rate setpoint.
    """

    alpha: float = 0.25
    window: int = 64
    refresh_every: float = 0.5
    mode: str = "p95"
    min_samples: int = 3
    propagate: bool = True
    safety: bool = False
    safety_target: float = 0.01


class OnlineProfiler:
    """Streaming per-(m, e, B) service-time estimator over a cold-start table.

    ``observe`` folds each completed quantum's measured service time into a
    per-cell EWMA mean and a bounded last-``window`` sample buffer (the
    streaming P95); ``materialize`` renders the current belief as a fresh
    :class:`ProfileTable` (estimates where a cell has ≥ ``min_samples``
    observations, drift-ratio-propagated cold-start values elsewhere, batch
    monotonicity re-enforced exactly like ``ProfileTable.measure``);
    ``maybe_refresh`` rate-limits materialisation to ``refresh_every``
    seconds of serving time. This is the runtime-adaptive profiling loop of
    BCEdge grafted onto the paper's Sec. IV-B offline profiler: the offline
    table is the cold start, observations take over cell by cell.
    """

    def __init__(self, base: ProfileTable, config: AdaptConfig = AdaptConfig()):
        assert config.mode in ("p95", "mean"), config.mode
        assert 0 < config.alpha <= 1 and config.window >= 1
        assert config.refresh_every > 0 and config.min_samples >= 1
        self.base = base
        self.config = config
        shape = base.latency.shape
        self._count = np.zeros(shape, dtype=np.int64)
        self._ewma = np.zeros(shape, dtype=np.float64)
        self._windows: Dict[Tuple[int, int, int], deque] = {}
        self._ratio: Optional[float] = None  # global EWMA of observed/base
        self._last_refresh = 0.0
        self._dirty = False
        self.safety = (
            SafetyController(target=config.safety_target)
            if config.safety else None
        )

    # -- ingestion -----------------------------------------------------------

    def _cell(self, m: int, e: int, batch: int) -> Tuple[int, int, int]:
        b_idx = int(np.searchsorted(self.base.batch_sizes, batch))
        return m, e, min(b_idx, len(self.base.batch_sizes) - 1)

    def observe(self, m: int, e: int, batch: int, service: float,
                now: float) -> None:
        """Fold one quantum's measured service time (seconds) into the
        (m, e, batch) cell's estimators at serving time ``now``."""
        assert service > 0, "service times must be positive"
        cell = self._cell(m, e, batch)
        a = self.config.alpha
        if self._count[cell] == 0:
            self._ewma[cell] = service
        else:
            self._ewma[cell] += a * (service - self._ewma[cell])
        self._count[cell] += 1
        win = self._windows.get(cell)
        if win is None:
            win = self._windows[cell] = deque(maxlen=self.config.window)
        win.append(service)
        ratio = service / float(self.base.latency[cell])
        self._ratio = (
            ratio if self._ratio is None
            else self._ratio + a * (ratio - self._ratio)
        )
        self._dirty = True

    def observe_latency(self, latency: float, deadline: float) -> None:
        """Feed one completion's end-to-end latency vs its effective
        deadline to the safety controller (no-op when safety is off)."""
        if self.safety is not None:
            self.safety.observe(latency, deadline)

    def observe_dropped(self, n: int) -> None:
        """Feed ``n`` shed requests to the safety controller as certain
        violations, keeping its stream consistent with ``summarize()``'s
        ``(late + dropped) / (done + dropped)`` accounting (no-op when
        safety is off)."""
        if self.safety is not None:
            for _ in range(int(n)):
                self.safety.observe_violation()

    def ingest_quantum(self, m: int, e: int, batch_size: int, service: float,
                       now: float, batch, default_slo: float
                       ) -> Optional[ProfileTable]:
        """The one per-quantum feedback step of the simulator (in the
        reference also of the cluster and the live engine, which the port
        does not thread it through yet): fold the (m, e, B) service sample in
        (skipped if the measured service rounds to ≤ 0 — possible under a
        coarse live clock), feed each served request's latency-vs-deadline
        to the safety controller, and return the cadence-gated refreshed
        table for the caller to swap into its scheduler (``None`` = keep).
        ``batch`` is the list of served Requests; ``default_slo`` fills in
        for requests without a per-request deadline."""
        if service > 0:
            self.observe(m, e, batch_size, service, now)
        if self.safety is not None:
            for req in batch:
                self.safety.observe(
                    now - req.arrival,
                    default_slo if req.deadline is None else req.deadline)
        return self.maybe_refresh(now)

    # -- inspection ----------------------------------------------------------

    @property
    def num_observations(self) -> int:
        return int(self._count.sum())

    @property
    def drift_ratio(self) -> float:
        """Global EWMA of observed / cold-start service time (1.0 = no
        drift seen yet)."""
        return 1.0 if self._ratio is None else float(self._ratio)

    def cell_stats(self, m: int, e: int, batch: int
                   ) -> Tuple[int, float, float]:
        """(count, EWMA mean, window P95) for one (m, e, batch) cell;
        estimates are 0.0 until the cell has been observed."""
        cell = self._cell(m, e, batch)
        n = int(self._count[cell])
        if n == 0:
            return 0, 0.0, 0.0
        p95 = float(np.percentile(np.asarray(self._windows[cell]), 95.0))
        return n, float(self._ewma[cell]), p95

    # -- materialisation -----------------------------------------------------

    def materialize(self) -> ProfileTable:
        """Render the current belief as a fresh :class:`ProfileTable`.

        Cells with ≥ ``min_samples`` observations carry their streaming
        estimate (``mode``); the rest keep the cold-start value, scaled by
        the global drift ratio when ``propagate`` is on. Batch monotonicity
        is re-enforced (``np.maximum.accumulate``, as in
        ``ProfileTable.measure``) and the safety controller's multiplier is
        applied last.
        """
        cfg = self.config
        lat = self.base.latency.copy()
        if cfg.propagate and self._ratio is not None:
            lat *= self._ratio
        seen = self._count >= cfg.min_samples
        if cfg.mode == "mean":
            lat[seen] = self._ewma[seen]
        else:
            for cell, win in self._windows.items():
                if seen[cell]:
                    lat[cell] = np.percentile(np.asarray(win), 95.0)
        lat = np.maximum.accumulate(lat, axis=2)
        table = dataclasses.replace(
            self.base, latency=lat,
            meta={**self.base.meta, "builder": "online",
                  "observations": self.num_observations,
                  "drift_ratio": self.drift_ratio},
        )
        if self.safety is not None and self.safety.multiplier > 1.0:
            table = table.with_safety(self.safety.multiplier)
        return table

    def maybe_refresh(self, now: float) -> Optional[ProfileTable]:
        """Materialise a refreshed table iff ``refresh_every`` seconds of
        serving time have passed since the last refresh *and* new
        observations arrived; else ``None`` (the scheduler keeps its
        current table)."""
        if not self._dirty or now - self._last_refresh < self.config.refresh_every:
            return None
        self._last_refresh = now
        self._dirty = False
        return self.materialize()


def make_profiler(base: ProfileTable,
                  config: Optional[AdaptConfig]) -> Optional[OnlineProfiler]:
    """Build an :class:`OnlineProfiler` from an :class:`AdaptConfig`
    (``None`` config = adaptation off; the stock static-table path)."""
    return None if config is None else OnlineProfiler(base, config)
