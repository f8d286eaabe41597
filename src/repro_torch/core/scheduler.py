"""The EdgeServing online scheduler (paper Sec. V, Algorithm 1).

One-step-greedy deadline-aware scheduling: per non-empty queue, pick
``B* = min(|Q_m|, B_max)`` (Eq. 5) and the deepest SLO-feasible exit
``e*`` (Eq. 6); predict the post-decision queue state (all other tasks wait
``L(m, e*, B*)`` longer); score it with the stability score (Eq. 4); and
serve the candidate minimising the predicted score (Eq. 7).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot
from repro_torch.core.request import Decision
from repro_torch.core.scoring import make_scoring_backend
from repro_torch.core.urgency import DEFAULT_CLIP, urgency_np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Shared knobs for all scheduling policies.

    Attributes:
      slo:        per-request latency deadline tau (seconds).
      max_batch:  B_max (paper default: 10).
      clip:       urgency clip C (paper example: 10).
      allowed_exits: optional subset of exit indices the scheduler may use
                  (paper Fig. 7 exit-configuration study); None = all.
      lattice:    False (default) = the paper-exact Eq. 5 batch rule
                  ``B* = min(|Q_m|, B_max)``; True = batch size becomes a
                  scheduling degree of freedom: each queue contributes one
                  candidate per ladder rung and the stability score picks
                  the global argmin over the joint (model, exit, batch)
                  lattice (beyond-paper extension; see docs/scheduler.md).
      batch_ladder: explicit lattice rungs; rungs above the Eq. 5 cap are
                  dropped and the cap itself is always included. None =
                  geometric ladder {1, 2, 4, ...} up to the cap.
      backend:    stability-score scoring engine for the Algorithm-1
                  schedulers: ``numpy`` (default; float64 host reference),
                  ``torch`` (the plain float32 tensor version) or ``cuda``
                  (the hand-written CUDA kernel); see
                  ``repro_torch.core.scoring``. All backends understand
                  per-task deadlines; baselines ignore the knob.
      device:     the device the ``torch`` and ``cuda`` backends score on;
                  None = the CUDA card (raises when there is none). Tests
                  pass ``"cpu"``, where both run the plain version.
    """

    slo: float = 0.050
    max_batch: int = 10
    clip: float = DEFAULT_CLIP
    allowed_exits: Optional[Tuple[int, ...]] = None
    lattice: bool = False
    batch_ladder: Optional[Tuple[int, ...]] = None
    backend: str = "numpy"
    device: Optional[str] = None


class Scheduler:
    """Base class: a policy maps a queue snapshot to a Decision."""

    name = "base"

    def __init__(self, table: ProfileTable, config: SchedulerConfig):
        self.table = table
        self.config = config
        self.scoring = make_scoring_backend(config.backend, config.device)
        exits = config.allowed_exits or tuple(range(table.num_exits))
        # Deduplicate + sort shallow->deep once; Eq. 6 scans deep->shallow.
        self._exits = tuple(sorted(set(exits)))
        assert self._exits, "at least one exit point must be allowed"
        assert all(0 <= e < table.num_exits for e in self._exits)

    # -- shared sub-procedures (Eq. 5 / Eq. 6) -------------------------------

    def batch_size(self, qlen: int) -> int:
        """Eq. 5: B* = min(|Q_m|, B_max)."""
        return min(qlen, self.config.max_batch)

    def batch_candidates(self, qlen: int) -> Tuple[int, ...]:
        """Candidate batch sizes for a queue of length ``qlen``.

        Greedy (``config.lattice=False``): the single Eq. 5 batch. Lattice:
        the configured ladder clipped to the Eq. 5 cap, cap always included,
        ordered descending so equal-score ties resolve toward serving more.
        """
        cap = self.batch_size(qlen)
        if cap <= 0:
            return ()
        if not self.config.lattice:
            return (cap,)
        if self.config.batch_ladder is not None:
            rungs = {int(b) for b in self.config.batch_ladder if 1 <= b <= cap}
        else:
            rungs = set()
            b = 1
            while b < cap:
                rungs.add(b)
                b *= 2
        rungs.add(cap)
        return tuple(sorted(rungs, reverse=True))

    def select_exit(
        self, m: int, w_max: float, batch: int, tau: Optional[float] = None
    ) -> Tuple[int, float]:
        """Eq. 6: deepest allowed exit with ``w_max + L(m,e,B) <= tau``.

        Falls back to the *shallowest* allowed exit when no exit is feasible
        (the task will violate regardless; minimising service time minimises
        collateral damage to other queues — paper Sec. VI-D shows the fast
        fallback exit is what sustains SLO compliance).

        ``tau`` defaults to the global SLO; heterogeneous-SLO workloads pass
        the head-of-line task's own deadline (``snapshot.oldest_tau``).

        Returns: (exit_idx, L(m, exit_idx, batch)).
        """
        if tau is None:
            tau = self.config.slo
        for e in reversed(self._exits):
            lat = self.table(m, e, batch)
            if w_max + lat <= tau:
                return e, lat
        e0 = self._exits[0]
        return e0, self.table(m, e0, batch)

    def candidate(self, snapshot: QueueSnapshot, m: int) -> Tuple[int, int, float]:
        """(B*, e*, L) for queue ``m`` under Eq. 5 + Eq. 6 (the oldest task's
        own deadline bounds feasibility under heterogeneous SLOs)."""
        batch = self.batch_size(snapshot.qlen(m))
        exit_idx, lat = self.select_exit(
            m, snapshot.w_max(m), batch,
            tau=snapshot.oldest_tau(m, self.config.slo),
        )
        return batch, exit_idx, lat

    # -- shared candidate enumeration + scoring (Eq. 5/6 -> Eq. 4/7) ---------

    def enumerate_candidates(
        self, snapshot: QueueSnapshot
    ) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
        """Flatten the feasible (m, e, B) lattice for this snapshot.

        The one candidate-enumeration step shared by every Algorithm-1
        scheduler: with ``config.lattice=False`` each non-empty queue
        contributes exactly its Eq. 5 candidate (the greedy layout); with
        the lattice on, one candidate per ladder rung. Returns
        ``(cand_queue, cand_batch, cand_exit, cand_latency, cand_wmax)``
        arrays of equal length N, in (queue asc, batch desc) order. Exits
        follow the Eq. 6 deepest-feasible/fallback rule at each rung's
        latency, bounded by the head-of-line task's own deadline.
        """
        queues: List[int] = []
        batches: List[int] = []
        exits: List[int] = []
        lats: List[float] = []
        wmaxes: List[float] = []
        for m in snapshot.nonempty():
            w_max = snapshot.w_max(m)
            tau_m = snapshot.oldest_tau(m, self.config.slo)
            for b in self.batch_candidates(snapshot.qlen(m)):
                e, lat = self.select_exit(m, w_max, b, tau=tau_m)
                queues.append(m)
                batches.append(b)
                exits.append(e)
                lats.append(lat)
                wmaxes.append(w_max)
        return (
            np.asarray(queues, dtype=np.int64),
            np.asarray(batches, dtype=np.int64),
            np.asarray(exits, dtype=np.int64),
            np.asarray(lats, dtype=np.float64),
            np.asarray(wmaxes, dtype=np.float64),
        )

    def score_candidates(
        self,
        snapshot: QueueSnapshot,
        cand_latency: np.ndarray,
        cand_batch: np.ndarray,
        cand_queue: np.ndarray,
    ) -> np.ndarray:
        """One scoring entry point for all backends (Sec. V-C prediction +
        Eq. 4): per-task deadlines ride along as an [M, maxQ] tau matrix
        when the snapshot carries any, else the scalar SLO fast path."""
        w, mask = snapshot.padded()
        tau = (snapshot.padded_taus(self.config.slo)
               if snapshot.has_deadlines else self.config.slo)
        return self.scoring.score(
            w, mask, cand_latency, cand_batch, cand_queue,
            tau, self.config.clip)

    def decide_scored(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        """The shared Algorithm-1 decision path: enumerate -> score through
        the configured backend -> Eq. 7 argmin (ties -> larger w_max, then
        candidate order: more urgent queue first, then larger batch)."""
        cand_queue, batches, exits, lats, w_maxes = self.enumerate_candidates(
            snapshot)
        if len(cand_queue) == 0:
            return None
        scores = self.score_candidates(snapshot, lats, batches, cand_queue)
        order = np.lexsort((-w_maxes, scores))
        i = int(order[0])
        return Decision(
            model=int(cand_queue[i]),
            exit_idx=int(exits[i]),
            batch_size=int(batches[i]),
            predicted_latency=float(lats[i]),
            stability_score=float(scores[i]),
        )

    # -- policy ---------------------------------------------------------------

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        """Return the decision for this round, or None if all queues empty."""
        raise NotImplementedError

    def prune(self, snapshot: QueueSnapshot) -> "list[tuple[int, int]]":
        """Optional admission control: ``[(model, n_oldest_to_drop), ...]``.

        EdgeServing never rejects requests (late tasks still run and count
        as violations); Symphony sheds expired requests under overload.
        """
        return []


class EdgeServingScheduler(Scheduler):
    """Algorithm 1: stability-score deadline-aware model selection.

    With the default ``backend="numpy"`` this is the paper-exact Python
    loop (the reference the vectorised/accelerated paths are tested
    against); any other backend routes through the shared
    ``decide_scored`` path so accelerated scoring is one config switch
    away for every Algorithm-1 scheduler.
    """

    name = "edgeserving"

    def batch_candidates(self, qlen: int) -> Tuple[int, ...]:
        """The paper-exact policy always uses the single Eq. 5 batch —
        `config.lattice` upgrades ``make_scheduler("edgeserving")`` to
        :class:`LatticeEdgeServingScheduler` rather than altering this
        class, so the accelerated `decide_scored` route enumerates exactly
        the candidates the reference loop scores (backend choice can never
        change this policy's decisions)."""
        cap = self.batch_size(qlen)
        return (cap,) if cap > 0 else ()

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        if self.scoring.name != "numpy":
            return self.decide_scored(snapshot)
        nonempty = snapshot.nonempty()
        if not nonempty:
            return None
        tau, clip = self.config.slo, self.config.clip
        het = snapshot.has_deadlines  # per-task tau arrays (scalar otherwise)
        taus = {m: snapshot.taus(m, tau) for m in nonempty} if het else None

        # Urgency is additive across queues, so precompute per-queue wait
        # arrays once; each candidate shifts *all* surviving tasks by L_m.
        best: Optional[Decision] = None
        for m in nonempty:
            batch, exit_idx, lat = self.candidate(snapshot, m)
            # Queue status prediction (Sec. V-C): served tasks removed; all
            # remaining tasks in every queue wait lat longer.
            score = 0.0
            for m2 in nonempty:
                w = snapshot.waits[m2]
                t = taus[m2] if het else tau
                if m2 == m:
                    w = w[batch:]  # FIFO: the batch oldest tasks are served
                    if het:
                        t = t[batch:]
                if len(w):
                    score += float(urgency_np(w + lat, t, clip).sum())
            if (
                best is None
                or score < best.stability_score
                or (
                    score == best.stability_score
                    and snapshot.w_max(m) > snapshot.w_max(best.model)
                )
            ):
                best = Decision(
                    model=m,
                    exit_idx=exit_idx,
                    batch_size=batch,
                    predicted_latency=lat,
                    stability_score=score,
                )
        return best


class VectorizedEdgeServingScheduler(Scheduler):
    """Numerically identical to EdgeServingScheduler, vectorised.

    Beyond-paper engineering: one O(M^2 * maxQ) padded-matrix evaluation
    per round instead of Python loops, dispatched through the configured
    :class:`repro_torch.core.scoring.ScoringBackend` (numpy float64 by
    default — bitwise-identical to the reference — or torch/CUDA for the
    many-queue regime).
    """

    name = "edgeserving-vec"

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        return self.decide_scored(snapshot)


class LatticeEdgeServingScheduler(VectorizedEdgeServingScheduler):
    """Joint (model, exit, batch) candidate-lattice scheduling.

    Beyond-paper extension of Algorithm 1: instead of fixing
    ``B* = min(|Q_m|, B_max)`` (Eq. 5) and searching only over models, every
    non-empty queue contributes one candidate per batch-ladder rung (see
    ``Scheduler.batch_candidates``), each with its own Eq. 6 deepest-feasible
    exit at that batch's latency. All candidates are scored with the same
    Sec. V-C queue-status prediction in one padded pass through the
    configured scoring backend (numpy / torch / the CUDA
    ``repro_torch.kernels.stability_score`` kernel), and the global
    argmin wins.

    Why this helps under tight deadlines: a smaller-than-Eq.-5 batch has a
    lower service latency L, which (a) shifts every other queue's tasks less
    — less collateral urgency — and (b) can make a deeper exit feasible for
    the served tasks. The stability score already prices exactly this
    trade-off; the lattice merely exposes the action space to it (cf. BCEdge
    / D-STACK adaptive batching). With the lattice restricted to the single
    Eq. 5 rung this scheduler is decision-identical to
    ``VectorizedEdgeServingScheduler`` (tested).

    Candidate order is (queue ascending, batch descending), and score ties
    resolve by (larger w_max, then candidate order) — so ties prefer the
    more urgent queue, then serving more tasks, exactly generalising the
    greedy tiebreak.
    """

    name = "edgeserving-lattice"

    def __init__(self, table: ProfileTable, config: SchedulerConfig):
        # The class *is* the lattice policy: force the switch on so that
        # make_scheduler("edgeserving-lattice") with a default config does
        # not silently degenerate to the greedy single-rung ladder.
        if not config.lattice:
            config = dataclasses.replace(config, lattice=True)
        super().__init__(table, config)
