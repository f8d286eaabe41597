"""Compiled serving simulator: one run = one fixed-shape float64 step, looped.

The event loop of ``repro_torch.core.simulator.ServingSimulator`` is pure
Python. This module refactors a whole serving run into fixed-shape tensor
state so that thousands of runs advance side by side on the card (the port
of the reference's ``src/repro/core/simfast.py``, which does the same with
``jax.jit(jax.vmap(lax.scan(step)))``):

  * per-model arrival times become one ``[M, P]`` float64 tensor per lane,
    sorted and padded with ``+inf``; a FIFO queue is then just the
    contiguous window ``[served_m, served_m + qlen_m)`` of that tensor, so
    ingest is a count of window entries ``<= t`` and the queue's wait vector
    is one gather of static width ``max_queue``;
  * the profile tables become dense ``[M, E, B_max+1]`` latency tensors
    (scheduler belief and execution ground truth separately, so
    ``sched_table`` / ``model_map`` deployment mixes work unchanged);
  * the batch ladder (Eq. 5 / the lattice generalisation) becomes a static
    ``[B_max+1, R]`` rung table built by calling the *actual* scheduler's
    ``batch_candidates`` for every possible cap;
  * one scheduling round (ingest -> enumerate the (m, e, B) lattice ->
    Eq. 6 exit per candidate -> Sec. V-C / Eq. 4 scoring -> Eq. 7 argmin
    with the reference tiebreak -> pop batch, advance clock) is one step;
    idle rounds are folded into the following dispatch, so the step count
    is bounded by the dispatch count, not the event count.

Every tensor carries a leading lane axis ``[L, ...]`` (independent traces,
seeds x rates, side by side). On the card each chunk of steps is a captured
CUDA graph: static input and carry buffers written in place, each step's
outputs written into a preallocated ``[steps, L]`` buffer, nothing inside
the graph synchronising with the host. The CPU runs the same step eagerly.
No ``torch.compile``: a fused kernel may contract ``(t + L) / tau - 1`` into
an FMA and break the bitwise clock.

Everything runs in float64: the clock evolves by the *identical* IEEE
operations as the Python loop (``t + L``, ``nextafter``), so dispatch and
finish timestamps are bitwise-equal and decisions stay equivalent — the
stability scores differ only at the ~ulp level (summation order, ``exp``'s
last bit, the factored path below), which the Eq. 7 argmin is insensitive
to outside exact structural ties, where both engines apply the identical
(score, w_max, candidate order) tiebreak.

Scoring runs in one of two modes, selected automatically:

  * **factored** (the fast path): Eq. 3 urgency obeys
    ``exp((t + L - a)/tau - 1) = exp((t + L)/tau - 1) * exp(-a/tau)``, so
    the per-*task* exponential ``E = exp(-a/tau)`` is precomputed once per
    run on the host and each step pays only ``[N, M]`` exponentials instead
    of ``[N, M, max_queue]``. Used only when ``max(arrival)/min(tau) <=
    700``, where ``E`` stays a normal float64.
  * **direct** (the reference formula ``lattice_stability_scores``, shared
    with the scoring backends, in float64): used for long-horizon /
    tight-deadline runs outside the factored range, and forceable via
    ``factored=False``.

Deliberately unsupported (rejected loudly with :class:`ScanEngineUnsupported`,
never approximated): schedulers outside the Algorithm-1 family (Symphony's
prune/next_wake, LQF/EDF), non-default scoring backends, service-time noise,
device drift, online adaptation, and per-request deadlines that vary within
a model's queue (trace replay). The Python loop remains the engine for
those.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import operator
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.baselines import (
    AllFinalDeadlineAwareScheduler,
    NoBatchingScheduler,
)
from repro_torch.core.metrics import summarize_arrays
from repro_torch.core.profile import ProfileTable
from repro_torch.core.request import Completion, Decision, Request, ServingTrace
from repro_torch.core.scheduler import (
    EdgeServingScheduler,
    LatticeEdgeServingScheduler,
    Scheduler,
    VectorizedEdgeServingScheduler,
)
from repro_torch.core.simulator import SimResult
from repro_torch.core.telemetry import DecisionRecord, Tracer
from repro_torch.core.urgency import lattice_stability_scores
from repro_torch.core.workloads import TraceColumns
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["ScanEngineUnsupported", "simulate_scan", "simulate_scan_batch"]


class ScanEngineUnsupported(NotImplementedError):
    """A feature the compiled engine does not reproduce bit-for-bit.

    The scan path refuses rather than approximates: silent semantic drift
    in a compiled rewrite of a discrete-event simulator is exactly what the
    equivalence tests exist to prevent. Use the Python engine
    (``SweepSpec.engine="python"`` / ``ServingSimulator``) for these."""


# The Algorithm-1 family whose decisions the scan step reproduces: shared
# Eq. 5/6 candidate enumeration + stability-score argmin, no prune, no
# next_wake. Exact types, not isinstance: an unknown subclass may override
# decide()/batch_candidates() in ways the compiled step knows nothing about.
_SUPPORTED_SCHEDULERS = (
    EdgeServingScheduler,
    VectorizedEdgeServingScheduler,
    LatticeEdgeServingScheduler,
    AllFinalDeadlineAwareScheduler,
    NoBatchingScheduler,
)

_MAX_QUEUE_DEFAULT = 64  # initial window; doubled (new buffers) on overflow
_FACTORED_RANGE = 700.0  # max(arrival)/min(tau) bound keeping exp(-a/tau) normal
# Steps per captured CUDA graph. A chunk of ``chunk_steps`` (up to 1024)
# replays this graph chunk_steps / GRAPH_STEPS times: capture and
# instantiation grow with the graph's node count (~60 kernels a step), a
# replay costs a few microseconds of host time whatever its length, and
# results do not depend on where the steps are cut.
GRAPH_STEPS = 32

F64 = torch.float64
I64 = torch.int64

# Host wall seconds of each part of the scan entry points, summed over calls:
# "generate" (a seed band's traces), "plan" (unpacking, tables, packing and
# the upload), "steps" (a chunk's replays or eager steps and the fetch of
# its outputs, so on the card the device's time too), "parse" (the cluster
# scan's host mirror), "fail-over" (its host barriers) and "rollup"
# (metrics from the codes). Two clock reads a part per chunk; callers clear
# it before a run they split.
split_seconds: Dict[str, float] = collections.defaultdict(float)


@contextlib.contextmanager
def _timed(part: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        split_seconds[part] += time.perf_counter() - t0


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class _StaticKey:
    """Everything that shapes the compiled step (the graph-cache key)."""

    num_models: int
    num_exits: int
    max_queue: int
    pad_len: int          # P: padded per-model arrival-array length
    chunk_steps: int      # S: steps per host check of done / overflow
    max_batch: int
    ladder: Tuple[Tuple[int, ...], ...]   # [B_max+1][R] batch rungs (0 = pad)
    allowed: Tuple[bool, ...]             # [E] allowed-exit mask
    fallback_exit: int                    # shallowest allowed exit (Eq. 6)
    clip: float
    factored: bool        # factored-exponential scoring vs direct Eq. 3
    emit_aux: bool        # also record the score and margin per round


class _GraphedSteps:
    """Static buffers and one step for ``lanes`` lanes of one static key.

    ``advance()`` moves every lane ``graph_steps`` steps and returns that
    block's outputs, step-major ``[graph_steps, L]``. On the card the block
    is a captured CUDA graph, replayed; on the CPU the same Python runs
    eagerly. Subclasses define the carry, the inputs, the outputs and
    ``_step(row)``, which reads and writes only those buffers."""

    def __init__(self, device: torch.device, graph_steps: int):
        self.device = device
        self.graph_steps = graph_steps
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    # -- subclass interface -------------------------------------------------
    carry: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]

    def _step(self, row: int) -> None:
        raise NotImplementedError

    # -- driving ------------------------------------------------------------
    def _steps(self) -> None:
        for row in range(self.graph_steps):
            self._step(row)

    def eager(self) -> Tuple[torch.Tensor, ...]:
        """One block run op by op (the CPU path; on the card, the reference
        the graph replay is checked against)."""
        self._steps()
        return tuple(y.clone() for y in self.outputs)

    def capture(self) -> None:
        """Capture the block as a CUDA graph. A warm-up block runs first on
        a side stream (first-use initialisation must not happen inside the
        capture) and its effect on the carry is undone. A capture that
        fails raises: there is no eager fallback on the card."""
        saved = [c.clone() for c in self.carry]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._steps()
            for c, v in zip(self.carry, saved):
                c.copy_(v)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._steps()
        self.graph = graph

    def advance(self) -> Tuple[torch.Tensor, ...]:
        if self.device.type != "cuda":
            return self.eager()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        return tuple(y.clone() for y in self.outputs)


def _score_and_pick(s: _GraphedSteps, t, w_max, batches, lat_sel, mask_b,
                    win, win_ew):
    """One scheduling round's Eq. 6 exits, Sec. V-C / Eq. 4 scores and
    Eq. 7 pick, shared by the single-device and the cluster step ``s``.

    ``t [L]`` is the round's clock, ``w_max [L, M]`` each queue's head
    wait, ``batches [L, M, R]`` its rungs, ``lat_sel [L, M, E, R]`` their
    latencies at the queue's cap, ``mask_b [L, M, Q]`` the queued slots,
    ``win [L, M, Q]`` their arrival times and ``win_ew`` their
    ``exp(-a/tau)`` factors (factored mode only, else ``None``). Returns
    ``(pick, m_star, e_star, b_star, has_work, scores, scores_v, best)``.
    """
    key = s.key
    L, M, R, N = s.L, key.num_models, s.R, s.N
    inf = s.inf
    valid = (batches > 0).reshape(L, N)
    # Eq. 6: the deepest feasible allowed exit per rung, else the fallback
    feas = ((w_max[:, :, None, None] + lat_sel
             <= s.tau.view(1, M, 1, 1)) & s.allowed)
    deepest = torch.where(feas, s.e_axis, -1).amax(2)          # [L, M, R]
    e_sel = torch.where(deepest >= 0, deepest, key.fallback_exit)
    # the reference sums one selected latency with zeros: a gather reads
    # the same value exactly
    lat_cand = torch.gather(lat_sel, 2, e_sel[:, :, None, :])[:, :, 0]

    cand_batch = batches.reshape(L, N)
    cand_lat = lat_cand.reshape(L, N)
    Q = mask_b.shape[2]
    if key.factored:
        # urgency(w + L) = min(A * E, C), A = exp((t + L)/tau - 1) per
        # (candidate, queue), E = exp(-a/tau) per task (host-computed):
        # [N, M] exponentials per round instead of [N, M, Q]. amp = inf on
        # deep drains is benign: the where() masks the inf * 0 pad NaNs,
        # real tasks clip to C exactly.
        amp = torch.exp((t[:, None, None] + cand_lat[:, :, None])
                        / s.tau.view(1, 1, M) - 1.0)            # [L, N, M]
        urg = torch.where(
            mask_b[:, None],
            torch.minimum(amp[..., None] * win_ew[:, None], s.clip),
            0.0)                                                # [L, N, M, Q]
        # torch sums in another order than XLA: the score (and the aux
        # score and margin) may differ from the reference's by an ulp;
        # decisions, clocks and metrics may not.
        total = urg.sum(dim=(2, 3))
        own = urg.view(L, N * M, Q).index_select(1, s.own_rows)
        removed = torch.where(s.pos_q < cand_batch[:, :, None],
                              own, 0.0).sum(2)
        scores = total - removed
    else:
        w = torch.where(mask_b, t[:, None, None] - win, 0.0)
        scores = lattice_stability_scores(
            w, mask_b.to(F64), cand_lat, cand_batch, s.cand_queue,
            s.tau[:, None], s.clip)

    # Eq. 7 argmin with the reference tiebreak: min score, then max w_max,
    # then the first candidate. argmax of an integer mask returns the first
    # maximal index, as jnp.argmax does.
    scores_v = torch.where(valid, scores, inf)
    best = scores_v.amin(1)
    wm_c = w_max[:, :, None].expand(L, M, R).reshape(L, N)
    tie = valid & (scores_v == best[:, None])
    wm_best = torch.where(tie, wm_c, -inf).amax(1)
    pick = (tie & (wm_c == wm_best[:, None])).to(torch.int32).argmax(1)
    has_work = valid.any(1)

    m_star = s.cand_queue[pick]
    e_star = e_sel.reshape(L, N).gather(1, pick[:, None])[:, 0]
    b_star = cand_batch.gather(1, pick[:, None])[:, 0]
    return pick, m_star, e_star, b_star, has_work, scores, scores_v, best


class _ScanSteps(_GraphedSteps):
    """The single-device scan step for ``L`` lanes.

    Carry (per lane): ``t`` clock, ``served[M]`` popped count per queue,
    ``busy`` time, ``done``, ``overflow``. Inputs: ``arr_t``/``arr_ew``
    ``[L, M, P]`` (arrival time, ``exp(-a/tau)``; ``+inf`` / 0 padded),
    ``lat_by_cap [M, B_max+1, E, R]`` scheduler-belief latency per (queue,
    queue-length cap, exit, rung), ``exec_lat [M, E, B_max+1]`` ground
    truth, ``tau [M]``, ``limit`` = horizon + drain cap."""

    def __init__(self, key: _StaticKey, lanes: int, device: torch.device):
        super().__init__(device, min(GRAPH_STEPS, key.chunk_steps))
        self.key = key
        M, E, Q, P = (key.num_models, key.num_exits, key.max_queue,
                      key.pad_len)
        Bmax = key.max_batch
        L = lanes
        R = len(key.ladder[0])
        self.L, self.R, self.N = L, R, M * R

        def zeros(*shape, dtype=F64):
            # Every float tensor here is float64: torch's default float32
            # would silently break the bitwise clock.
            return torch.zeros(shape, dtype=dtype, device=device)

        # constants
        self.ladder = torch.tensor(key.ladder, dtype=I64, device=device)
        self.allowed = torch.tensor(key.allowed, dtype=torch.bool,
                                    device=device).view(1, 1, E, 1)
        self.e_axis = torch.arange(E, device=device).view(1, 1, E, 1)
        self.m_idx = torch.arange(M, device=device).view(1, M)
        self.n_idx = torch.arange(self.N, device=device).view(1, self.N)
        self.cand_queue = torch.arange(M, device=device).repeat_interleave(R)
        self.win = torch.arange(Q + 1, device=device).view(1, 1, Q + 1)
        self.pos_q = torch.arange(Q, device=device)
        self.inf = torch.tensor(float("inf"), dtype=F64, device=device)
        # a device scalar: a Python float would be copied to the card inside
        # the graph capture, which torch refuses
        self.clip = torch.tensor(key.clip, dtype=F64, device=device)
        # flat row offsets (index_select / take are cheaper than advanced
        # indexing, and read the same elements)
        self.m_rows = self.m_idx * (Bmax + 1)                  # [1, M]
        self.own_rows = self.n_idx[0] * M + self.cand_queue    # [N]
        # inputs
        self.arr_t = zeros(L, M, P)
        self.arr_ew = zeros(L, M, P)
        self.lat_by_cap = zeros(M, Bmax + 1, E, R)
        self.exec_lat = zeros(M, E, Bmax + 1)
        self.tau = zeros(M)
        self.limit = zeros()
        # carry
        self.t = zeros(L)
        self.served = zeros(L, M, dtype=I64)
        self.busy = zeros(L)
        self.done = zeros(L, dtype=torch.bool)
        self.overflow = zeros(L, dtype=torch.bool)
        self.carry = (self.t, self.served, self.busy, self.done,
                      self.overflow)
        # outputs, step-major
        G = self.graph_steps
        self.code = zeros(G, L, dtype=I64)
        self.t_out = zeros(G, L)
        self.outputs = (self.code, self.t_out)
        if key.emit_aux:
            self.score = zeros(G, L)
            self.margin = zeros(G, L)
            self.outputs += (self.score, self.margin)

    def load(self, arr_t, arr_ew, lat_by_cap, exec_lat, tau_vec, limit):
        """Copy one batch's inputs into the static buffers and reset the
        carry (host arrays are float64 already)."""
        for buf, host in ((self.arr_t, arr_t), (self.arr_ew, arr_ew),
                          (self.lat_by_cap, lat_by_cap),
                          (self.exec_lat, exec_lat), (self.tau, tau_vec)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        self.limit.fill_(limit)
        for c in self.carry:
            c.zero_()

    def _step(self, row: int) -> None:
        key = self.key
        M, E, Q, P = (key.num_models, key.num_exits, key.max_queue,
                      key.pad_len)
        L, R = self.L, self.R
        inf = self.inf
        t0, served, busy, done, overflow = self.carry

        # FIFO queue content is the contiguous range [served, served + qlen)
        # of the sorted arrival row, so one width-(Q+1) window holds every
        # queued task plus the next future arrival; counting window entries
        # <= t *is* the reference loop's ingest cursor (t is monotone). A
        # count of Q+1 means the queue outgrew the window and the host must
        # retry wider. lax.dynamic_slice clamps its start to [0, P-(Q+1)];
        # the gather clamps the same way (P = pow2(n_max + Q + 2) keeps the
        # clamp from ever binding, but a clamped start must read the same).
        start = served.clamp(0, P - (Q + 1))
        idx = start[:, :, None] + self.win                     # [L, M, Q+1]
        arr_win = torch.gather(self.arr_t, 2, idx)             # [L, M, Q+1]
        qlen0 = (arr_win <= t0[:, None, None]).sum(2)

        # Idle rounds fold into the dispatch that always follows them: when
        # every queue is empty, the reference sleeps to the next arrival
        # with one-ulp strict progress (t = nextafter(max(t, next), inf)),
        # ingests it, and dispatches. torch.nextafter is exact in float64
        # on the CPU and the card alike.
        nxt = torch.where(arr_win > t0[:, None, None], arr_win,
                          inf).amin(dim=(1, 2))                # [L]
        empty0 = ~(qlen0 > 0).any(1)
        t_idle = torch.nextafter(torch.maximum(t0, nxt), inf)
        halt = empty0 & ~torch.isfinite(nxt)          # no work ever again
        t = torch.where(empty0 & ~halt, t_idle, t0)   # halt: break pre-advance
        over_cap = empty0 & (t > self.limit)          # idle past drain cap
        qlen_raw = (arr_win <= t[:, None, None]).sum(2)
        overflow_new = overflow | (qlen_raw > Q).any(1)
        qlen_c = qlen_raw.clamp_max(Q)

        mask_b = self.pos_q < qlen_c[:, :, None]                # [L, M, Q]
        # Oldest wait per queue, zero when empty (QueueSnapshot.w_max).
        w_max = torch.where(qlen_c > 0, t[:, None] - arr_win[:, :, 0], 0.0)

        # Candidate lattice: one rung row per queue from the static ladder
        # (queue asc, batch desc — the reference enumeration order).
        cap = qlen_c.clamp_max(key.max_batch)                   # [L, M]
        batches = self.ladder.index_select(0, cap.view(-1)).view(L, M, R)
        lat_sel = self.lat_by_cap.view(M * (key.max_batch + 1), E, R) \
            .index_select(0, (self.m_rows + cap).view(-1)) \
            .view(L, M, E, R)
        win_ew = (torch.gather(self.arr_ew, 2, idx[:, :, :Q])
                  if key.factored else None)
        (pick, m_star, e_star, b_star, has_work, scores, scores_v,
         best) = _score_and_pick(self, t, w_max, batches, lat_sel, mask_b,
                                 arr_win[:, :, :Q], win_ew)
        B1 = key.max_batch + 1
        service = torch.take(self.exec_lat,
                             (m_star * E + e_star) * B1 + b_star)
        t_end = t + service

        active = ~done
        is_disp = active & has_work & ~over_cap
        t_new = torch.where(is_disp, t_end, torch.where(active, t, t0))
        pop = torch.where(is_disp, b_star, 0)
        served_new = served + torch.where(self.m_idx == m_star[:, None],
                                          pop[:, None], 0)
        busy_new = busy + torch.where(is_disp, service, 0.0)
        # The reference breaks *after* advancing t past horizon + drain_cap
        # in the dispatch branch (the over-cap quantum still counts) and
        # *before* dispatching in the idle branch; an overflowed window
        # stops the lane for the host's retry.
        done_new = (done | halt | over_cap | (is_disp & (t_end > self.limit))
                    | overflow_new)

        # One integer codes the whole round: -1 = no dispatch, else
        # m + M*(e + E*b). Finish times and predicted latencies are
        # bitwise-recomputable on the host from (m, e, b) and t.
        self.code[row] = torch.where(is_disp, m_star + M * (e_star + E * b_star),
                                     -1)
        self.t_out[row] = t
        if key.emit_aux:
            # runner-up candidate score minus the winner's (inf with a single
            # candidate, 0 on an exact tie), as telemetry.decision_margin
            runner_up = torch.where(self.n_idx == pick[:, None], inf,
                                    scores_v).amin(1)
            self.score[row] = scores.gather(1, pick[:, None])[:, 0]
            self.margin[row] = runner_up - best
        for c, new in zip(self.carry, (t_new, served_new, busy_new, done_new,
                                       overflow_new)):
            c.copy_(new)


@functools.lru_cache(maxsize=16)
def _scan_steps(key: _StaticKey, lanes: int, device: torch.device
                ) -> _ScanSteps:
    """One set of static buffers (and, on the card, one captured graph) per
    (static key, lane count, device), reused across calls."""
    return _ScanSteps(key, lanes, device)


# ---------------------------------------------------------------------------
# Host-side packing and validation
# ---------------------------------------------------------------------------


def _validate_scheduler(scheduler: Scheduler) -> None:
    if type(scheduler) not in _SUPPORTED_SCHEDULERS:
        raise ScanEngineUnsupported(
            f"scan engine supports only the Algorithm-1 scheduler family "
            f"{sorted(c.__name__ for c in _SUPPORTED_SCHEDULERS)}; got "
            f"{type(scheduler).__name__!r} (Symphony's prune/next_wake and "
            f"the LQF/EDF baselines need the Python engine)"
        )
    if scheduler.scoring.name != "numpy":
        raise ScanEngineUnsupported(
            f"scan engine compiles its own scoring pass; the "
            f"backend={scheduler.scoring.name!r} knob only applies to the "
            f"Python engine — use the default backend='numpy'"
        )


@dataclasses.dataclass
class _Lane:
    """One arrival trace, unpacked into per-model columnar arrays."""

    requests: Sequence[Request]
    model: np.ndarray      # [n] queue index per request, arrival order
    arrival: np.ndarray    # [n] arrival times, sorted
    by_model: List[np.ndarray]   # per-model index lists into the trace
    tau_vec: np.ndarray    # [M] effective per-model deadline


def _unpack_lane(
    arrivals, num_models: int, slo: float
) -> _Lane:
    n = len(arrivals)
    if isinstance(arrivals, TraceColumns):
        # Columnar lane: already the arrays this function exists to build.
        model = arrivals.model
        arrival = arrivals.arrival
    else:
        # map(attrgetter) keeps attribute extraction in C: this runs once
        # per request per run, so it is the scan engine's host-side hot loop.
        model = np.fromiter(
            map(operator.attrgetter("model"), arrivals),
            dtype=np.int64, count=n,
        )
        arrival = np.fromiter(
            map(operator.attrgetter("arrival"), arrivals),
            dtype=np.float64,
            count=n,
        )
    if n and np.any(np.diff(arrival) < 0):
        raise ValueError("arrivals must be sorted by arrival time")
    if n and (model.min() < 0 or model.max() >= num_models):
        raise ValueError(
            f"arrival trace targets model {model.max()}, but the "
            f"simulation has {num_models} queues"
        )
    tau_vec = np.full(num_models, slo, dtype=np.float64)
    by_model = [np.flatnonzero(model == m) for m in range(num_models)]
    if isinstance(arrivals, TraceColumns):
        deadline = arrivals.deadline          # [n] with NaN = None, or None
    else:
        deadline = None
        distinct = set(map(operator.attrgetter("deadline"), arrivals))
        if distinct and distinct != {None}:
            deadline = np.fromiter(
                (np.nan if r.deadline is None else r.deadline
                 for r in arrivals),
                dtype=np.float64,
                count=n,
            )
    if deadline is not None:
        # Per-request deadlines present: supported iff constant per model.
        for m in range(num_models):
            d = deadline[by_model[m]]
            if len(d) == 0:
                continue
            has = ~np.isnan(d)
            if has.any():
                vals = np.unique(d[has])
                if len(vals) > 1 or not has.all():
                    raise ScanEngineUnsupported(
                        f"model {m} carries per-request deadlines that vary "
                        f"within its queue; the scan engine supports only "
                        f"per-model constant deadlines (trace replay with "
                        f"arbitrary deadline mixes needs the Python engine)"
                    )
                tau_vec[m] = float(vals[0])
    return _Lane(arrivals, model, arrival, by_model, tau_vec)


def _dense_latency(
    table: ProfileTable, rows: Sequence[int], num_exits: int, max_batch: int
) -> np.ndarray:
    """[M, E, B_max+1] lookup array via the table's own clamped ``__call__``
    (slot 0 is never dispatched; fill with batch 1 to stay finite)."""
    out = np.empty((len(rows), num_exits, max_batch + 1), dtype=np.float64)
    for i, row in enumerate(rows):
        for e in range(num_exits):
            out[i, e, 0] = table(row, e, 1)
            for b in range(1, max_batch + 1):
                out[i, e, b] = table(row, e, b)
    return out


def _build_ladder(scheduler: Scheduler, max_batch: int) -> Tuple[Tuple[int, ...], ...]:
    """[B_max+1][R] rung table from the scheduler's own ``batch_candidates``
    (cap -> descending rungs, 0-padded): greedy, lattice, custom ladders and
    the bs=1 ablation all serialise into one static array."""
    rows = [tuple(scheduler.batch_candidates(cap)) for cap in range(max_batch + 1)]
    width = max((len(r) for r in rows), default=1) or 1
    return tuple(r + (0,) * (width - len(r)) for r in rows)


def _pack_lanes(
    lanes: Sequence[_Lane], num_models: int, pad_len: int, factored: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """``[L, M, P]`` arrival times and ``exp(-arrival/tau)`` factors, +inf /
    0.0 padded (the pad's exponential factor is exactly the +inf
    arrival's)."""
    arr_t = np.full((len(lanes), num_models, pad_len), np.inf,
                    dtype=np.float64)
    arr_ew = np.zeros((len(lanes), num_models, pad_len), dtype=np.float64)
    for li, lane in enumerate(lanes):
        for m in range(num_models):
            a = lane.arrival[lane.by_model[m]]
            arr_t[li, m, : len(a)] = a
            if factored:
                arr_ew[li, m, : len(a)] = np.exp(-a / lane.tau_vec[m])
    return arr_t, arr_ew


# ---------------------------------------------------------------------------
# Result reconstruction (vectorised numpy, no per-request Python loop)
# ---------------------------------------------------------------------------


def _reconstruct(
    ys: "dict[str, np.ndarray]",
    lane: _Lane,
    table: ProfileTable,
    sched_lat: np.ndarray,
    exec_lat: np.ndarray,
    num_exits: int,
    horizon: float,
    warmup_tasks: int,
    model_map: Optional[Sequence[int]],
    busy: float,
    t_final: float,
    keep_completions: bool,
    keep_traces: bool,
    tracer: Optional[Tracer] = None,
    slo: float = 0.050,
) -> SimResult:
    M = len(lane.tau_vec)
    code = ys["code"]
    disp = code >= 0
    dcode = code[disp]
    dm = dcode % M
    rest = dcode // M
    de = rest % num_exits
    db = rest // num_exits
    dt0 = ys["t0"][disp]
    # t_end = t + L(m, e, B) is the identical IEEE add the step performed,
    # so recomputing it here is bitwise-faithful to the in-step clock.
    dt1 = dt0 + exec_lat[dm, de, db]
    n_arr = len(lane.model)
    # Reference completion order is: dispatch rounds in time order, FIFO
    # within each batch. The k-th dispatch of model m serves the next
    # ``db`` requests of m's arrival-ordered queue, so the per-model
    # position of each completion is (batches m served before this
    # dispatch) + (offset within this batch).
    D = len(dm)
    if D:
        db64 = db.astype(np.int64)
        gidx = np.repeat(np.arange(D), db64)
        starts = np.cumsum(db64) - db64
        off = np.arange(len(gidx)) - starts[gidx]   # 0..b-1, FIFO in batch
        prior = np.empty(D, dtype=np.int64)         # m's served-before count
        for m in range(M):
            sel = dm == m
            bm = np.where(sel, db64, 0)
            prior[sel] = (np.cumsum(bm) - bm)[sel]
        # trace index per completion, via the concatenated per-model lists
        bm_flat = np.concatenate(lane.by_model) if M else np.array([], np.int64)
        bm_off = np.zeros(M, dtype=np.int64)
        np.cumsum([len(ix) for ix in lane.by_model[:-1]], out=bm_off[1:])
        model = dm[gidx]
        ridx = bm_flat[bm_off[model] + prior[gidx] + off]
        exits = de[gidx].astype(np.int64)
        batches = db64[gidx]
        arrival = lane.arrival[ridx]
        dispatch = dt0[gidx]
        finish = dt1[gidx]
        tau = lane.tau_vec[model]
    else:
        model = exits = batches = ridx = np.array([], dtype=np.int64)
        arrival = dispatch = finish = tau = np.array([], dtype=np.float64)

    n_completed = len(model)
    residual = n_arr - n_completed
    span = max(t_final, horizon)
    metrics = summarize_arrays(
        models=model,
        exits=exits,
        batches=batches,
        latencies=finish - arrival,
        queueings=dispatch - arrival,
        taus=tau,
        table=table,
        warmup_tasks=warmup_tasks,
        busy_time=busy,
        span=span,
        residual_queue=residual,
        model_map=model_map,
        dropped=0,
    )

    completions: List[Completion] = []
    if keep_completions and n_completed:
        for i in range(n_completed):
            req = lane.requests[int(ridx[i])]
            completions.append(Completion(
                req_id=req.req_id,
                model=int(model[i]),
                arrival=req.arrival,
                dispatch=float(dispatch[i]),
                finish=float(finish[i]),
                exit_idx=int(exits[i]),
                batch_size=int(batches[i]),
                deadline=req.deadline,
            ))

    traces: List[ServingTrace] = []
    if keep_traces:
        dplat = sched_lat[dm, de, db]
        dscore = ys["score"][disp]
        for i in range(len(dm)):
            traces.append(ServingTrace(
                t_start=float(dt0[i]),
                t_end=float(dt1[i]),
                decision=Decision(
                    model=int(dm[i]),
                    exit_idx=int(de[i]),
                    batch_size=int(db[i]),
                    predicted_latency=float(dplat[i]),
                    stability_score=float(dscore[i]),
                ),
                queue_lengths=(),
            ))

    trace = None
    if tracer is not None:
        # Host-side timeline reconstruction from the packed decision codes.
        # Everything but score/margin is recomputed by the *identical* IEEE
        # ops the Python engine's snapshot performs, so the timeline is
        # bitwise-equal to the Python engine's trace:
        #   depth_m  = |arrivals_m <= t| - served_before_m   (ingest rule)
        #   age_m    = t - arrival_of_oldest_queued          (w_max rule)
        D = len(dm)
        db64d = db.astype(np.int64)
        depths = np.zeros((D, M), dtype=np.int64)
        ages = np.zeros((D, M), dtype=np.float64)
        for m in range(M):
            arr_m = lane.arrival[lane.by_model[m]]
            bm = np.where(dm == m, db64d, 0)
            served_before = np.cumsum(bm) - bm
            cnt = np.searchsorted(arr_m, dt0, side="right")
            depth_m = cnt - served_before
            depths[:, m] = depth_m
            if len(arr_m):
                head = np.minimum(served_before, len(arr_m) - 1)
                ages[:, m] = np.where(depth_m > 0, dt0 - arr_m[head], 0.0)
        scores_d = ys["score"][disp]
        margins_d = ys["margin"][disp]
        dplat = sched_lat[dm, de, db]
        for k in range(D):
            tracer.decisions.append(DecisionRecord(
                t=float(dt0[k]), device=0, model=int(dm[k]),
                exit_idx=int(de[k]), batch_size=int(db[k]),
                predicted_latency=float(dplat[k]), t_end=float(dt1[k]),
                score=float(scores_d[k]), margin=float(margins_d[k]),
                queue_depths=tuple(int(x) for x in depths[k]),
                oldest_ages=tuple(float(x) for x in ages[k]),
            ))
        for i in range(n_completed):
            req = lane.requests[int(ridx[i])]
            tracer.record_completion(
                req, float(dispatch[i]), float(finish[i]),
                int(exits[i]), int(batches[i]), slo)
        served_total = np.zeros(M, dtype=np.int64)
        np.add.at(served_total, dm, db64d)
        for m in range(M):
            for j in lane.by_model[m][served_total[m]:]:
                tracer.record_residual(lane.requests[int(j)], slo,
                                       device=-1)
        trace = tracer.freeze(
            engine="scan", num_models=M, num_devices=1, slo=slo,
            horizon=horizon, span=span, warmup_used=metrics.warmup_used,
            n_arrivals=n_arr)
    return SimResult(metrics, completions, traces, span, trace=trace)


def _host_blocks(blocks: List[Tuple[torch.Tensor, ...]]) -> List[np.ndarray]:
    """Step-major ``[steps, L]`` output blocks as lane-major host arrays
    ``[L, steps]``, one per output."""
    return [torch.cat([b[j] for b in blocks]).T.cpu().numpy()
            for j in range(len(blocks[0]))]


@dataclasses.dataclass
class _ScanPlan:
    """One batch's host-side inputs: everything the step needs but the
    queue window's width, which the overflow retry doubles."""

    lanes: List[_Lane]
    num_models: int
    n_max: int            # densest per-model arrival count of any lane
    n_total_max: int      # longest lane
    budget: int           # the step bound: rounds <= dispatches + 2
    factored: bool
    fixed: dict           # the static key's fields that stay put
    sched_lat: np.ndarray
    exec_lat: np.ndarray
    lat_by_cap: np.ndarray
    tau_vec: np.ndarray
    limit: float

    def first_window(self, max_queue: Optional[int]) -> int:
        return max_queue or min(_MAX_QUEUE_DEFAULT,
                                _pow2(max(self.n_max, 1)))

    def key(self, max_queue: int) -> _StaticKey:
        return _StaticKey(
            max_queue=max_queue, pad_len=_pow2(self.n_max + max_queue + 2),
            chunk_steps=min(_pow2(self.budget), 1024), **self.fixed)

    def load(self, steps: "_ScanSteps") -> None:
        steps.load(*_pack_lanes(self.lanes, self.num_models,
                                steps.key.pad_len, self.factored),
                   self.lat_by_cap, self.exec_lat, self.tau_vec, self.limit)


def _plan_scan(scheduler: Scheduler, table: ProfileTable, arrival_lanes,
               horizon: float, num_models: Optional[int],
               model_map: Optional[Sequence[int]], drain_cap: float,
               factored: Optional[bool], emit_aux: bool) -> _ScanPlan:
    M = num_models or scheduler.table.num_models
    cfg = scheduler.config
    lanes = [_unpack_lane(lane, M, cfg.slo) for lane in arrival_lanes]
    tau_vec = lanes[0].tau_vec if lanes else np.full(M, cfg.slo)
    for lane in lanes[1:]:
        if not np.array_equal(lane.tau_vec, tau_vec):
            raise ScanEngineUnsupported(
                "all lanes of one scan batch must share the same per-model "
                "deadline vector (split differing lanes into separate calls)"
            )
    n_max = max(
        (max((len(ix) for ix in lane.by_model), default=0) for lane in lanes),
        default=0,
    )
    n_total_max = max((len(lane.model) for lane in lanes), default=0)
    last_arrival = max(
        (lane.arrival[-1] for lane in lanes if len(lane.arrival)),
        default=0.0,
    )
    if factored is None:
        factored = bool(last_arrival / tau_vec.min() <= _FACTORED_RANGE)
    E = scheduler.table.num_exits
    Bmax = cfg.max_batch
    ladder = _build_ladder(scheduler, Bmax)
    rows = (
        [model_map[m] for m in range(M)] if model_map is not None
        else list(range(M))
    )
    sched_lat = _dense_latency(scheduler.table, list(range(M)), E, Bmax)
    # [M, cap, E, R]: the candidate lattice's latencies per queue-length
    # cap, so in-step enumeration is one gather over cap.
    ladder_np = np.array(ladder, dtype=np.int64)
    lat_by_cap = np.ascontiguousarray(
        sched_lat[:, :, ladder_np].transpose(0, 2, 1, 3)
    )
    fixed = dict(
        num_models=M, num_exits=E, max_batch=Bmax, ladder=ladder,
        allowed=tuple(e in scheduler._exits for e in range(E)),
        fallback_exit=scheduler._exits[0], clip=cfg.clip,
        factored=factored, emit_aux=emit_aux,
    )
    return _ScanPlan(
        lanes=lanes, num_models=M, n_max=n_max, n_total_max=n_total_max,
        # Idle rounds fold into dispatches, so rounds <= dispatches + 2 and
        # every dispatch serves >= 1 request.
        budget=n_total_max + 4, factored=factored, fixed=fixed,
        sched_lat=sched_lat, exec_lat=_dense_latency(table, rows, E, Bmax),
        lat_by_cap=lat_by_cap, tau_vec=tau_vec, limit=horizon + drain_cap,
    )


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def simulate_scan_batch(
    scheduler: Scheduler,
    table: ProfileTable,
    arrival_lanes: Sequence[Sequence[Request]],
    horizon: float,
    num_models: Optional[int] = None,
    warmup_tasks: int = 100,
    model_map: Optional[Sequence[int]] = None,
    drain_cap: float = 600.0,
    max_queue: Optional[int] = None,
    keep_completions: bool = False,
    keep_traces: bool = False,
    factored: Optional[bool] = None,
    tracers: Optional[Sequence[Optional[Tracer]]] = None,
    device: DeviceLike = None,
) -> List[SimResult]:
    """Run one serving experiment per arrival lane, all lanes side by side
    in one lane-batched float64 step (seeds x rates in one launch stream).
    All lanes share the scheduler config and tables; only the traces
    differ. Returns one :class:`SimResult` per lane, in order.

    The step runs in fixed-size chunks with a host-side completion check
    between them, so a grid of light lanes does not pay the worst-case step
    bound of its heaviest lane. If any lane's queue outgrows the
    ``max_queue`` window the whole batch retries with the window doubled
    (results are never truncated). ``factored=None`` auto-selects the
    factored-exponential scoring path whenever its float64 range condition
    holds (see module docstring).

    ``tracers`` (optional, one ``telemetry.Tracer`` or ``None`` per lane)
    turns on telemetry: the step emits its score/margin aux and the host
    reconstructs each traced lane's full decision timeline and request
    spans from the packed codes — bitwise-equal to the Python engine's
    trace on everything but score/margin (ulp-level). Tracing never changes
    the step's decisions or the metrics.

    ``device``: ``None`` runs the lanes on the card (each chunk a replayed
    CUDA graph) and raises where there is none; ``"cpu"`` runs the same
    step eagerly on the host.
    """
    _validate_scheduler(scheduler)
    dev = resolve_device(device)
    if tracers is None:
        tracers = [None] * len(arrival_lanes)
    assert len(tracers) == len(arrival_lanes), "one tracer slot per lane"
    any_tracer = any(tr is not None for tr in tracers)
    with _timed("plan"):
        plan = _plan_scan(scheduler, table, arrival_lanes, horizon,
                          num_models, model_map, drain_cap, factored,
                          emit_aux=keep_traces or any_tracer)
    lanes = plan.lanes
    if not lanes:
        return []
    for tr in tracers:
        if tr is not None:
            tr.reset()

    Q = plan.first_window(max_queue)
    while True:
        key = plan.key(Q)
        S = key.chunk_steps
        steps = _scan_steps(key, len(lanes), dev)
        with _timed("plan"):
            plan.load(steps)
        ys_chunks = []
        steps_run = 0
        while True:
            with _timed("steps"):
                blocks = [steps.advance()
                          for _ in range(S // steps.graph_steps)]
                ys_chunks.append(_host_blocks(blocks))
                # the once-per-chunk host read of done / overflow
                done = steps.done.cpu().numpy()
                overflow = steps.overflow.cpu().numpy()
            steps_run += S
            if bool(done.all()) or bool(overflow.any()):
                break
            if steps_run >= plan.budget + S:
                raise RuntimeError(
                    f"scan engine exceeded its step budget "
                    f"({steps_run} rounds for {plan.n_total_max} arrivals); "
                    f"this indicates a termination bug — please report"
                )
        if bool(overflow.any()):
            if Q >= max(plan.n_max, 1):
                raise RuntimeError(
                    "scan engine overflowed a max_queue window already as "
                    "large as the densest arrival trace — please report"
                )
            if any_tracer:
                t_over = steps.t.cpu().numpy()
                for i, tr in enumerate(tracers):
                    if tr is not None and bool(overflow[i]):
                        tr.record_event(
                            float(t_over[i]), "overflow-retry",
                            max_queue_from=Q, max_queue_to=Q * 2)
            Q = Q * 2  # retry with a wider window (sticky-flag overflow)
            continue
        break

    names = (
        ("code", "t0", "score", "margin") if key.emit_aux
        else ("code", "t0")
    )
    t_fin = steps.t.cpu().numpy()
    busy_fin = steps.busy.cpu().numpy()
    with _timed("rollup"):
        cat = {
            n: np.concatenate([c[j] for c in ys_chunks], axis=1)
            for j, n in enumerate(names)
        }
        results = []
        for i, lane in enumerate(lanes):
            lane_ys = {n: col[i] for n, col in cat.items()}
            results.append(_reconstruct(
                lane_ys, lane, table, plan.sched_lat, plan.exec_lat,
                key.num_exits, horizon, warmup_tasks, model_map,
                float(busy_fin[i]), float(t_fin[i]), keep_completions,
                keep_traces, tracer=tracers[i], slo=scheduler.config.slo,
            ))
    return results


def simulate_scan(
    scheduler: Scheduler,
    table: ProfileTable,
    arrivals: Sequence[Request],
    horizon: float,
    num_models: Optional[int] = None,
    warmup_tasks: int = 100,
    model_map: Optional[Sequence[int]] = None,
    drain_cap: float = 600.0,
    max_queue: Optional[int] = None,
    keep_completions: bool = False,
    keep_traces: bool = False,
    factored: Optional[bool] = None,
    tracer: Optional[Tracer] = None,
    device: DeviceLike = None,
) -> SimResult:
    """Compiled twin of ``ServingSimulator(...).run(...)`` for one trace:
    same arguments-to-metrics contract, one lane-batched step loop instead
    of the Python event loop. See the module docstring for the supported
    feature matrix; unsupported configurations raise
    :class:`ScanEngineUnsupported`.
    """
    return simulate_scan_batch(
        scheduler, table, [arrivals], horizon,
        num_models=num_models, warmup_tasks=warmup_tasks,
        model_map=model_map, drain_cap=drain_cap, max_queue=max_queue,
        keep_completions=keep_completions, keep_traces=keep_traces,
        factored=factored,
        tracers=None if tracer is None else [tracer],
        device=device,
    )[0]
