"""Thousand-seed confidence bands over the compiled scan engines.

The paper's headline numbers (SLO violation ratio, P95 latency) are
single-seed point estimates. This module exploits the lane axis of
``core/simfast.py`` / ``core/clusterfast.py`` to rerun a serving cell at
every seed in a band and attach uncertainty to each reported metric (the
port of the reference's ``src/repro/core/seedband.py``; the statistics are
host numpy, op for op the reference's):

- :func:`simulate_scan_seedband` — single-device cells. One arrival
  trace per seed (same scenario, same rates), all lanes through
  ``simulate_scan_batch`` in fixed-size chunks, one
  :class:`~repro_torch.core.metrics.ServingMetrics` per seed.
- :func:`simulate_cluster_scan_seedband` — fleet cells through
  ``simulate_cluster_scan_batch`` (``keep_completions=False`` so the
  per-seed rollup never materialises completion objects).
- :func:`summarize_band` — per-metric roll-up: mean, sample sd, a
  normal-approximation CI on the mean (width shrinks ~1/sqrt(n)), and
  the empirical P2.5/P97.5 percentile band across seeds (width reflects
  seed-to-seed spread and does *not* shrink with n).
- :func:`compare_bands` — two-sample z test on the mean gap between two
  seed columns (e.g. stability-aware vs JSQ violation ratio), reporting
  whether the gap is significant at the band level.

Determinism: the per-seed columns are a pure function of (scenario,
seeds, cell parameters). Chunking the seed axis changes how many lanes
share one batch but not any lane's result — the batch engines are
lane-independent — so columns are bitwise-stable across chunk sizes and
reruns (``tests/test_torch_seedband.py``). ``device=`` flows through
``**kwargs`` to the batch engines (``None`` = the card, ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .metrics import ServingMetrics
from .workloads import ArrivalProcess

__all__ = [
    "BandSummary",
    "GapSummary",
    "SeedBandResult",
    "compare_bands",
    "simulate_cluster_scan_seedband",
    "simulate_scan_seedband",
    "summarize_band",
]

#: Default number of lanes per batch. Bounds the [N, M, Q] scoring
#: temporaries of a step; results are chunk-size invariant.
DEFAULT_CHUNK = 64

#: Metrics fig17 puts bands on by default.
BAND_FIELDS = ("violation_ratio", "p95_latency")


def _z_for_level(level: float) -> float:
    """Two-sided standard-normal quantile: P(|Z| <= z) = level.

    Solved by bisection on ``erf`` (no scipy in the image); |error| is
    below 1e-12 which is far inside the Monte-Carlo noise it scales.
    """
    if not 0.0 < level < 1.0:
        raise ValueError(f"confidence level must be in (0, 1), got {level}")
    lo, hi = 0.0, 16.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if math.erf(mid / math.sqrt(2.0)) < level:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass(frozen=True)
class BandSummary:
    """Uncertainty roll-up of one metric across a seed band."""

    n: int
    mean: float
    sd: float            # sample standard deviation (ddof=1; 0.0 if n < 2)
    ci_lo: float         # normal-approx CI on the mean: mean +- z*sd/sqrt(n)
    ci_hi: float
    band_lo: float       # empirical percentile band across seeds
    band_hi: float       # (P2.5 / P97.5 at the default 95% level)
    level: float = 0.95

    @property
    def ci_width(self) -> float:
        return self.ci_hi - self.ci_lo

    def __str__(self) -> str:
        return (f"{self.mean:.6g} ± {0.5 * self.ci_width:.2g} "
                f"[band {self.band_lo:.6g}, {self.band_hi:.6g}] (n={self.n})")


def summarize_band(values: Sequence[float], level: float = 0.95) -> BandSummary:
    """Mean, mean-CI, and percentile band of one per-seed metric column."""
    col = np.asarray(values, dtype=np.float64)
    if col.ndim != 1 or col.size == 0:
        raise ValueError("summarize_band expects a non-empty 1-D column")
    n = int(col.size)
    mean = float(col.mean())
    sd = float(col.std(ddof=1)) if n > 1 else 0.0
    z = _z_for_level(level)
    half = z * sd / math.sqrt(n) if n > 1 else 0.0
    tail = 100.0 * (1.0 - level) / 2.0
    band_lo, band_hi = np.percentile(col, [tail, 100.0 - tail])
    return BandSummary(
        n=n, mean=mean, sd=sd,
        ci_lo=mean - half, ci_hi=mean + half,
        band_lo=float(band_lo), band_hi=float(band_hi),
        level=level,
    )


@dataclasses.dataclass(frozen=True)
class GapSummary:
    """Two-sample z test on the mean gap between two seed columns."""

    gap: float           # mean(a) - mean(b)
    ci_lo: float
    ci_hi: float
    significant: bool    # CI excludes zero at ``level``
    level: float = 0.95

    def __str__(self) -> str:
        verdict = "significant" if self.significant else "not significant"
        return (f"gap {self.gap:+.6g} "
                f"[{self.ci_lo:+.6g}, {self.ci_hi:+.6g}] ({verdict})")


def compare_bands(
    a: Sequence[float], b: Sequence[float], level: float = 0.95
) -> GapSummary:
    """Is mean(a) - mean(b) distinguishable from zero at ``level``?"""
    ca = np.asarray(a, dtype=np.float64)
    cb = np.asarray(b, dtype=np.float64)
    if ca.size < 2 or cb.size < 2:
        raise ValueError("compare_bands needs at least 2 seeds per side")
    gap = float(ca.mean() - cb.mean())
    se = math.sqrt(ca.var(ddof=1) / ca.size + cb.var(ddof=1) / cb.size)
    half = _z_for_level(level) * se
    return GapSummary(
        gap=gap, ci_lo=gap - half, ci_hi=gap + half,
        significant=not (gap - half <= 0.0 <= gap + half),
        level=level,
    )


@dataclasses.dataclass(frozen=True)
class SeedBandResult:
    """Per-seed ``ServingMetrics`` columns for one serving cell."""

    seeds: Tuple[int, ...]
    metrics: Tuple[ServingMetrics, ...]   # one per seed, same order

    def column(self, field: str) -> np.ndarray:
        """One metric as a float64 column over the seed axis."""
        return np.array(
            [getattr(m, field) for m in self.metrics], dtype=np.float64
        )

    def band(self, field: str, level: float = 0.95) -> BandSummary:
        return summarize_band(self.column(field), level)

    def bands(
        self, fields: Sequence[str] = BAND_FIELDS, level: float = 0.95
    ) -> Dict[str, BandSummary]:
        return {f: self.band(f, level) for f in fields}


def _lanes_for(
    process: ArrivalProcess, horizon: float, seeds: Sequence[int]
) -> List:
    from .simfast import _timed

    # Columnar lanes: at 10^3 seeds, materialising Request objects costs
    # more than the scan itself; generate_columns is bitwise-identical.
    with _timed("generate"):
        return [process.generate_columns(horizon, seed=int(s))
                for s in seeds]


def _chunked(seq: Sequence, size: int):
    for i in range(0, len(seq), size):
        yield seq[i:i + size]


def simulate_scan_seedband(
    scheduler,
    table,
    process: ArrivalProcess,
    horizon: float,
    seeds: Sequence[int],
    chunk: int = DEFAULT_CHUNK,
    **kwargs,
) -> SeedBandResult:
    """Single-device cell at every seed in ``seeds``.

    One arrival trace per seed via ``process.generate(horizon, seed)``,
    run through ``simulate_scan_batch`` in chunks of ``chunk`` lanes.
    Extra kwargs flow to the batch engine (``keep_completions`` defaults
    to False: the band only needs metrics columns).
    """
    from .simfast import simulate_scan_batch

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    kwargs.setdefault("keep_completions", False)
    lanes = _lanes_for(process, horizon, seeds)
    out: List[ServingMetrics] = []
    for block in _chunked(lanes, chunk):
        results = simulate_scan_batch(
            scheduler, table, block, horizon, **kwargs
        )
        out.extend(r.metrics for r in results)
    return SeedBandResult(seeds=tuple(int(s) for s in seeds),
                          metrics=tuple(out))


def simulate_cluster_scan_seedband(
    devices,
    process: ArrivalProcess,
    horizon: float,
    seeds: Sequence[int],
    chunk: int = DEFAULT_CHUNK,
    **kwargs,
) -> SeedBandResult:
    """Fleet cell at every seed in ``seeds`` via the compiled cluster scan.

    Extra kwargs flow to ``simulate_cluster_scan_batch`` (``dispatcher``,
    ``policy``, ``power_d``, ...); ``keep_completions`` defaults to False
    so a 10^3-seed band never materialises completion objects.
    """
    from .clusterfast import simulate_cluster_scan_batch

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    kwargs.setdefault("keep_completions", False)
    lanes = _lanes_for(process, horizon, seeds)
    out: List[ServingMetrics] = []
    for block in _chunked(lanes, chunk):
        results = simulate_cluster_scan_batch(
            devices, block, horizon, **kwargs
        )
        out.extend(r.metrics for r in results)
    return SeedBandResult(seeds=tuple(int(s) for s in seeds),
                          metrics=tuple(out))
