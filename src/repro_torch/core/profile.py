"""Offline profile table L(m, e, B) and accuracy table A(m, e) (paper Sec. IV).

The profile table is the contract between the offline phase and the online
scheduler: under time-division sharing, profiled latency *is* runtime
latency (paper reports CoV < 3%), so a single dense ``[M, E, B]`` array of
seconds fully specifies the scheduler's latency model.

Builders:

  * ``ProfileTable.measure``           -- wall-clock measurement of real
    callables (the faithful path; ``repro_torch.runtime.server`` drives it
    against the models on the card).
  * ``ProfileTable.paper_rtx3080``     -- a synthetic table calibrated to the
    paper's published RTX 3080 characteristics (Fig. 2 trends + the Fig. 4
    saturation point), with the GTX 1650 and Jetson rescalings.

The host arithmetic is numpy float64, op for op the reference's, so the
synthetic tables are bitwise the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProfileTable:
    """Dense latency/accuracy profile.

    Attributes:
      model_names: length-M model identifiers.
      exit_names:  length-E exit identifiers, shallowest -> deepest
                   (e.g. ["layer1", "layer2", "layer3", "final"]).
      batch_sizes: length-B increasing batch sizes (paper: 1..10).
      latency:     ``[M, E, B]`` float64 seconds (P95 or mean per builder).
      accuracy:    ``[M, E]`` float64 top-1 accuracy in [0, 1].
      meta:        free-form provenance (platform, builder, date).
    """

    model_names: tuple
    exit_names: tuple
    batch_sizes: tuple
    latency: np.ndarray
    accuracy: np.ndarray
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        m, e, b = len(self.model_names), len(self.exit_names), len(self.batch_sizes)
        assert self.latency.shape == (m, e, b), self.latency.shape
        assert self.accuracy.shape == (m, e), self.accuracy.shape
        assert np.all(self.latency > 0), "latencies must be positive"
        # FIFO batching monotonicity: serving more items never gets cheaper.
        assert np.all(np.diff(self.latency, axis=2) >= -1e-12), (
            "latency must be non-decreasing in batch size"
        )

    # -- lookup ------------------------------------------------------------

    @property
    def num_models(self) -> int:
        return len(self.model_names)

    @property
    def num_exits(self) -> int:
        return len(self.exit_names)

    @property
    def max_batch(self) -> int:
        return int(self.batch_sizes[-1])

    def __call__(self, m: int, e: int, batch: int) -> float:
        """L(m, e, B) in seconds. ``batch`` is the actual batch size."""
        b_idx = int(np.searchsorted(self.batch_sizes, batch))
        b_idx = min(b_idx, len(self.batch_sizes) - 1)
        return float(self.latency[m, e, b_idx])

    def latencies_for_batch(self, m: int, batch: int) -> np.ndarray:
        """``[E]`` latency column for one model at one batch size."""
        b_idx = min(
            int(np.searchsorted(self.batch_sizes, batch)), len(self.batch_sizes) - 1
        )
        return self.latency[m, :, b_idx]

    def acc(self, m: int, e: int) -> float:
        return float(self.accuracy[m, e])

    # -- derived views -----------------------------------------------------

    def scaled(self, factor: float, name: str = "") -> "ProfileTable":
        """A platform-rescaled copy (used for cross-platform studies)."""
        return dataclasses.replace(
            self,
            latency=self.latency * factor,
            meta={**self.meta, "scaled_by": factor, "platform": name or
                  self.meta.get("platform", "") + f"*{factor:g}"},
        )

    def with_safety(self, multiplier: float) -> "ProfileTable":
        """A copy with every latency inflated by a safety ``multiplier``.

        The static headroom knob of the offline phase (paper Sec. IV-B
        records P95 for the same reason): analytic tables
        and mean-based estimates use it to absorb
        measurement optimism. The *adaptive* twin is
        ``SafetyController`` of the reference's ``core/adaptive.py``, which
        tunes this multiplier online from observed violation headroom.
        """
        return dataclasses.replace(self, latency=self.latency * multiplier)

    def with_batch_saturation(self, knee: int, slope: float = 0.85) -> "ProfileTable":
        """Model accelerator batch saturation past ``knee`` (BCEdge regime).

        Up to batch ``knee`` the original curve applies (batching is cheap);
        beyond it each extra item costs ``slope`` * the batch-1 latency —
        the compute-saturated regime where throughput no longer improves
        with batch size. This is the regime in which batch size becomes a
        real scheduling degree of freedom (see the lattice scheduler).
        """
        assert 1 <= knee <= self.max_batch and slope > 0
        bsz = np.asarray(self.batch_sizes, dtype=np.float64)
        # index by batch-size *value*, not position: the grid need not be
        # contiguous (measure() accepts arbitrary ladders)
        k_idx = int(np.searchsorted(self.batch_sizes, knee, side="right")) - 1
        assert k_idx >= 0, "knee below the smallest profiled batch"
        per_item = self.latency[:, :, 0:1] / float(self.batch_sizes[0])
        extra = np.maximum(bsz[None, None, :] - knee, 0.0) * slope
        saturated = self.latency[:, :, k_idx:k_idx + 1] + per_item * extra
        lat = np.where(bsz[None, None, :] <= knee, self.latency, saturated)
        lat = np.maximum.accumulate(lat, axis=2)
        return dataclasses.replace(
            self, latency=lat,
            meta={**self.meta, "batch_knee": knee, "batch_slope": slope},
        )

    def restrict_exits(self, exit_indices: Sequence[int]) -> "ProfileTable":
        """Keep only a subset of exits (paper Fig. 7 exit-configuration study)."""
        idx = list(exit_indices)
        return dataclasses.replace(
            self,
            exit_names=tuple(self.exit_names[i] for i in idx),
            latency=self.latency[:, idx, :],
            accuracy=self.accuracy[:, idx],
        )

    def select_models(self, model_indices: Sequence[int]) -> "ProfileTable":
        """Deployment mix view (paper Fig. 9 model-combination study)."""
        idx = list(model_indices)
        return dataclasses.replace(
            self,
            model_names=tuple(self.model_names[i] for i in idx),
            latency=self.latency[idx],
            accuracy=self.accuracy[idx],
        )

    # -- (de)serialisation ---------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "model_names": list(self.model_names),
                    "exit_names": list(self.exit_names),
                    "batch_sizes": list(self.batch_sizes),
                    "latency": self.latency.tolist(),
                    "accuracy": self.accuracy.tolist(),
                    "meta": self.meta,
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "ProfileTable":
        with open(path) as f:
            d = json.load(f)
        return ProfileTable(
            model_names=tuple(d["model_names"]),
            exit_names=tuple(d["exit_names"]),
            batch_sizes=tuple(d["batch_sizes"]),
            latency=np.asarray(d["latency"], dtype=np.float64),
            accuracy=np.asarray(d["accuracy"], dtype=np.float64),
            meta=d.get("meta", {}),
        )

    # -- builders ------------------------------------------------------------

    @staticmethod
    def measure(
        model_names: Sequence[str],
        exit_names: Sequence[str],
        batch_sizes: Sequence[int],
        run_fn: Callable[[int, int, int], None],
        accuracy: Optional[np.ndarray] = None,
        repeats: int = 20,
        warmup: int = 3,
        percentile: float = 95.0,
        meta: Optional[dict] = None,
    ) -> "ProfileTable":
        """Wall-clock profiling of ``run_fn(m, e, B)`` (paper Sec. IV-B).

        ``run_fn`` must execute one full inference for configuration
        ``(m, e, B)`` and block until complete (on CUDA: synchronize).
        Records the ``percentile`` latency over ``repeats`` runs after
        ``warmup`` discarded runs, exactly like the paper's profiler; batch
        monotonicity is re-enforced against measurement noise
        (``np.maximum.accumulate``). The resulting table is a point-in-time
        snapshot of the device — under thermal/DVFS/contention drift it is
        the *cold start* that an online profiler refreshes from observed
        completions.
        """
        m_n, e_n, b_n = len(model_names), len(exit_names), len(batch_sizes)
        lat = np.zeros((m_n, e_n, b_n), dtype=np.float64)
        for mi in range(m_n):
            for ei in range(e_n):
                for bi, bsz in enumerate(batch_sizes):
                    for _ in range(warmup):
                        run_fn(mi, ei, bsz)
                    samples = np.empty(repeats)
                    for r in range(repeats):
                        t0 = time.perf_counter()
                        run_fn(mi, ei, bsz)
                        samples[r] = time.perf_counter() - t0
                    lat[mi, ei, bi] = np.percentile(samples, percentile)
        # enforce batch monotonicity against measurement noise
        lat = np.maximum.accumulate(lat, axis=2)
        if accuracy is None:
            accuracy = np.full((m_n, e_n), np.nan)
        return ProfileTable(
            tuple(model_names), tuple(exit_names), tuple(batch_sizes),
            lat, np.asarray(accuracy, dtype=np.float64),
            meta={**(meta or {}), "builder": "measure", "percentile": percentile},
        )

    @staticmethod
    def paper_rtx3080() -> "ProfileTable":
        """Synthetic table calibrated to the paper's RTX 3080 numbers.

        Calibration targets (paper Sec. IV-C + Sec. VI-B):
          * batch 1 -> 10 raises latency ~2-3x (not 10x);
          * final exit of ResNet152 ~6-8x slower than its layer1 exit;
          * model ordering R50 < R101 < R152, gap widest at final;
          * All-Final saturates near lambda_152 ~ 140 req/s under the 3:2:1
            traffic ratio with B_max = 10 (utilisation = 1 at ~143 req/s with
            the constants below -- see tests/test_profile.py).
        """
        model_names = ("resnet50", "resnet101", "resnet152")
        exit_names = ("layer1", "layer2", "layer3", "final")
        batch_sizes = tuple(range(1, 11))
        # Batch-1 latency (ms); exit cost fractions approximate cumulative
        # bottleneck-stage FLOPs of each backbone with a stem offset.
        base_final_ms = np.array([2.8, 5.2, 7.6])        # R50, R101, R152 @ final
        exit_frac = np.array(
            [
                [0.22, 0.35, 0.62, 1.00],   # ResNet50  (final/layer1 ~ 4.5x)
                [0.16, 0.27, 0.66, 1.00],   # ResNet101 (~6.3x)
                [0.135, 0.24, 0.68, 1.00],  # ResNet152 (~7.4x: "6-8x")
            ]
        )
        bsz = np.arange(1, 11, dtype=np.float64)
        # L(B) = L(1) * (1 + slope*(B-1)); slope=1/6 -> 2.5x at B=10 ("2-3x").
        batch_curve = 1.0 + (bsz - 1.0) / 6.0
        lat_ms = (
            base_final_ms[:, None, None]
            * exit_frac[:, :, None]
            * batch_curve[None, None, :]
        )
        accuracy = np.array(
            [
                [0.076, 0.121, 0.308, 0.744],   # Table I, ResNet50
                [0.074, 0.145, 0.543, 0.779],   # ResNet101
                [0.073, 0.172, 0.474, 0.780],   # ResNet152
            ]
        )
        return ProfileTable(
            model_names, exit_names, batch_sizes, lat_ms * 1e-3, accuracy,
            meta={"builder": "paper_rtx3080", "platform": "rtx3080-calibrated"},
        )

    @staticmethod
    def paper_gtx1650() -> "ProfileTable":
        """GTX 1650-calibrated table: ~3.2x slower than the 3080 (paper VI-G)."""
        return ProfileTable.paper_rtx3080().scaled(3.2, "gtx1650-calibrated")

    @staticmethod
    def paper_jetson_orin_nano() -> "ProfileTable":
        """Jetson Orin Nano-calibrated: ~7x slower; paper uses tau=100 ms."""
        return ProfileTable.paper_rtx3080().scaled(7.0, "jetson-orin-nano-calibrated")
