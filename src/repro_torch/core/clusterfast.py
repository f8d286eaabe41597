"""Compiled cluster simulator: G per-device schedulers behind one step.

``repro_torch.core.cluster.ClusterSimulator`` is a pure-Python global event
loop: fine for one fig14 cell, far too slow for thousand-seed confidence
bands. This module turns the whole cluster run into fixed-shape float64
tensor state the way ``repro_torch.core.simfast`` does for the
single-device run (the port of the reference's
``src/repro/core/clusterfast.py``): one step per *global event* (failure <
arrival < device-round at equal timestamps, then device id — the reference
loop's exact ordering), every tensor with a leading lane axis (seeds x
rates), each chunk of steps a replayed CUDA graph on the card and the same
step run eagerly on the CPU.

State layout (per lane):

  * per-(device, model) FIFO queues become ring buffers ``qarr/qew[G, M, Q]``
    with ``qhead/qlen[G, M]`` cursors — unlike the single-device engine the
    queue contents cannot be a window into the sorted arrival array, because
    the dispatcher interleaves arrivals across devices dynamically and
    failover re-pushes orphans out of arrival order;
  * the arrival stream stays one sorted ``[n]`` array; the carry's ``ai``
    cursor is the reference loop's arrival index;
  * device timers: ``pend[G]`` (next scheduling-round time, ``+inf`` = none),
    ``inq[G]`` (a quantum is in flight), ``alive/done[G]``, ``clock/busy[G]``;
  * one round-robin counter (the only dispatcher state that survives
    compilation — see the dispatcher matrix below).

One step processes an *arrival burst* plus at most one round: up to ``K``
consecutive arrivals are dispatched first (compiled dispatcher pick -> ring
push -> one-ulp ``nextafter`` poke; each iteration re-checks that the next
event really is an arrival, so a poked wake-up correctly interrupts the
burst), then — if the next event is a device round — the earliest pending
device runs one Algorithm-1 scheduling round (ingest -> Eq. 5/6 candidate
lattice -> Sec. V-C scoring -> Eq. 7 argmin with the reference tiebreak ->
ring pop, quantum occupancy). Folding arrivals into the round step is pure
batching: every per-event computation is identical to the one-event-per-step
layout, but the [candidates x models x queue] scoring tensor is evaluated
once per round instead of once per event.

Compiled dispatcher family (`SUPPORTED_DISPATCHERS`):

  * ``round-robin`` — cumsum-rank pick over the eligible mask; the counter
    lives in the carry and (like the reference) does *not* advance when a
    single eligible device short-circuits the pick;
  * ``jsq`` — masked integer argmin of queued counts (ties -> lowest id);
  * ``least-loaded`` — masked argmin of the capacity-weighted backlog: the
    in-flight quantum remainder plus a precomputed ``[G, M, Q+1]``
    ``drain_cell`` table folded left-to-right over models, replaying
    ``drain_estimate``'s accumulation order bit-for-bit;
  * ``stability-aware`` — backlog plus the final-exit unit-batch belief
    ``b1_final[G, M]``, but only as a *full scan* (``power_d >= fleet
    size``): the ``k < len(eligible)`` branch draws
    ``numpy.Generator.choice`` samples that have no fixed-shape equivalent,
    so genuine power-of-d subsampling is rejected loudly.

Failure/failover runs as host-segmented barriers: the step freezes every
lane at the next ``fail_at`` time (events strictly before the barrier
execute; the frozen step is a no-op), the host pulls the carry, kills the
device, re-dispatches its orphans in (arrival, req_id) order through a numpy
mirror of the *identical* pick arithmetic (same IEEE ops, same tiebreaks,
shared round-robin counter via the carry), pushes them into the rings, and
resumes at the next barrier. Queue *identity* (which request sits where)
never enters the carry: the host reconstructs it from the emitted step codes
— pushes and pops per (device, model) are both chronological, so the k-th
pop is the k-th push.

Decisions, ``ServingMetrics`` and completions equal the Python
``ClusterSimulator``'s bitwise on the supported family, and a G=1 fleet
collapses bitwise to the single-device ``simulate_scan``.

Deliberately unsupported (rejected via :class:`ScanEngineUnsupported`):
schedulers outside the Algorithm-1 family, non-numpy scoring backends,
per-device drift / online adaptation / service noise, power-of-d
subsampling (above), heterogeneous exit counts, per-request deadlines
varying within a model, and telemetry tracers (the cluster scan does not
reconstruct cluster timelines — trace with the Python engine).
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.baselines import make_scheduler
from repro_torch.core.cluster import (
    DISPATCHERS,
    ClusterResult,
    DeviceSpec,
    drain_cell,
)
from repro_torch.core.metrics import DeviceMetrics, summarize, summarize_arrays
from repro_torch.core.request import Completion, Request
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.simfast import (
    _FACTORED_RANGE,
    _MAX_QUEUE_DEFAULT,
    F64,
    I64,
    ScanEngineUnsupported,
    _GraphedSteps,
    _Lane,
    _build_ladder,
    _dense_latency,
    _pow2,
    _score_and_pick,
    _timed,
    _unpack_lane,
    _validate_scheduler,
)
from repro_torch.core.telemetry import Tracer
from repro_torch.core.workloads import TraceColumns
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "SUPPORTED_DISPATCHERS",
    "simulate_cluster_scan",
    "simulate_cluster_scan_batch",
]

SUPPORTED_DISPATCHERS = ("round-robin", "jsq", "least-loaded",
                         "stability-aware")

# Arrivals absorbed per step before the (expensive) scoring round. Purely a
# throughput knob: any value produces identical decisions.
_BURST = 8
# Steps per captured CUDA graph (a step is ~8 arrival passes and a round,
# some 400 kernels); chunks of up to 256 steps replay it. Results do not
# depend on where the steps are cut.
GRAPH_STEPS = 16


@dataclasses.dataclass(frozen=True)
class _ClusterKey:
    """Everything that shapes the compiled cluster step (graph-cache key)."""

    num_devices: int
    num_models: int
    num_exits: int
    max_queue: int        # Q: ring capacity per (device, model)
    pad_len: int          # P: padded arrival-stream length
    chunk_steps: int      # S: steps per host check of blocked / overflow
    burst: int            # K: arrivals absorbed per step before the round
    max_batch: int
    ladder: Tuple[Tuple[int, ...], ...]
    allowed: Tuple[bool, ...]
    fallback_exit: int
    clip: float
    factored: bool
    dispatcher: str


_NAMES = ("ai", "qarr", "qew", "qhead", "qlen", "pend", "inq", "alive",
          "done", "clock", "busy", "rr", "blocked", "over")


class _ClusterSteps(_GraphedSteps):
    """The cluster step for ``L`` lanes.

    Carry (per lane): ``ai``; ``qarr/qew [G, M, Q]``; ``qhead/qlen [G, M]``;
    ``pend [G]`` (+inf = no round pending); ``inq/alive/done [G]``;
    ``clock/busy [G]``; ``rr``; ``blocked``; ``over``. Inputs: the arrival
    stream ``arr_t/arr_m/arr_ew [L, P]`` (+inf / 0 padded),
    ``lat_by_cap [G, M, B+1, E, R]``, ``exec_lat [G, M, E, B+1]``,
    ``drain_tab [G, M, Q+1]``, ``b1_final [G, M]``, ``tau [M]``, the
    placement mask ``place [G, M]``, ``limit`` = horizon + drain cap and
    ``barrier`` = the next failure time (+inf on the last segment)."""

    def __init__(self, key: _ClusterKey, lanes: int, device: torch.device):
        super().__init__(device, min(GRAPH_STEPS, key.chunk_steps))
        self.key = key
        G, M, E, Q, P = (key.num_devices, key.num_models, key.num_exits,
                         key.max_queue, key.pad_len)
        Bmax, K, L = key.max_batch, key.burst, lanes
        R = len(key.ladder[0])
        self.L, self.R, self.N = L, R, M * R

        def zeros(*shape, dtype=F64):
            # every float tensor float64: torch's default float32 would
            # silently break the bitwise clock
            return torch.zeros(shape, dtype=dtype, device=device)

        # constants
        self.ladder = torch.tensor(key.ladder, dtype=I64, device=device)
        self.allowed = torch.tensor(key.allowed, dtype=torch.bool,
                                    device=device).view(1, 1, E, 1)
        self.e_axis = torch.arange(E, device=device).view(1, 1, E, 1)
        self.m_idx = torch.arange(M, device=device).view(1, M)
        self.g_idx = torch.arange(G, device=device).view(1, G)
        self.n_idx = torch.arange(self.N, device=device).view(1, self.N)
        self.lane = torch.arange(L, device=device)
        self.cand_queue = torch.arange(M, device=device).repeat_interleave(R)
        self.ring = torch.arange(Q, device=device).view(1, 1, Q)
        self.pos_q = torch.arange(Q, device=device)
        self.inf = torch.tensor(float("inf"), dtype=F64, device=device)
        # a device scalar: a Python float would be copied to the card inside
        # the graph capture, which torch refuses
        self.clip = torch.tensor(key.clip, dtype=F64, device=device)
        # flat offsets: one (lane, device) row is lane * G + d, one (lane,
        # device, model) queue (lane * G + d) * M + m, one ring cell that
        # times Q plus the slot. index_select / take / put_ on them touch
        # the elements the reference's .at[...] updates touch, for a
        # fraction of advanced indexing's cost.
        self.lane_g = self.lane * G
        self.drain_rows = [(self.g_idx * M + mm) * (Q + 1) for mm in range(M)]
        self.own_rows = self.n_idx[0] * M + self.cand_queue
        # inputs
        self.arr_t = zeros(L, P)
        self.arr_m = zeros(L, P, dtype=I64)
        self.arr_ew = zeros(L, P)
        self.lat_by_cap = zeros(G, M, Bmax + 1, E, R)
        self.exec_lat = zeros(G, M, E, Bmax + 1)
        self.drain_tab = zeros(G, M, Q + 1)
        self.b1_final_t = zeros(M, G)       # [M, G]: one gather per model
        self.tau = zeros(M)
        self.place_t = zeros(M, G, dtype=torch.bool)
        self.limit = zeros()
        self.barrier = zeros()
        # carry, in the reference's order
        self.ai = zeros(L, dtype=I64)
        self.qarr = zeros(L, G, M, Q)
        self.qew = zeros(L, G, M, Q)
        self.qhead = zeros(L, G, M, dtype=I64)
        self.qlen = zeros(L, G, M, dtype=I64)
        self.pend = zeros(L, G)
        self.inq = zeros(L, G, dtype=torch.bool)
        self.alive = zeros(L, G, dtype=torch.bool)
        self.done = zeros(L, G, dtype=torch.bool)
        self.clock = zeros(L, G)
        self.busy = zeros(L, G)
        self.rr = zeros(L, dtype=I64)
        self.blocked = zeros(L, dtype=torch.bool)
        self.over = zeros(L, dtype=torch.bool)
        self.carry = tuple(getattr(self, n) for n in _NAMES)
        # outputs: [graph steps, L, K + 1] slots in execution order (K
        # arrival slots, then the round slot)
        self.code = zeros(self.graph_steps, L, K + 1, dtype=I64)
        self.t_out = zeros(self.graph_steps, L, K + 1)
        self.outputs = (self.code, self.t_out)

    def load(self, arr_t, arr_m, arr_ew, lat_by_cap, exec_lat, drain_tab,
             b1_final, tau_vec, place, limit) -> None:
        for buf, host in ((self.arr_t, arr_t), (self.arr_m, arr_m),
                          (self.arr_ew, arr_ew),
                          (self.lat_by_cap, lat_by_cap),
                          (self.exec_lat, exec_lat),
                          (self.drain_tab, drain_tab),
                          (self.b1_final_t, b1_final.T),
                          (self.tau, tau_vec), (self.place_t, place.T)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        self.limit.fill_(limit)

    def set_carry(self, host: dict) -> None:
        for n, buf in zip(_NAMES, self.carry):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(host[n])))

    def get_carry(self) -> dict:
        return {n: buf.cpu().numpy().copy()
                for n, buf in zip(_NAMES, self.carry)}

    def _arrival_once(self, row: int, k: int) -> None:
        """Process the next event iff it is an unfrozen arrival: compiled
        dispatcher pick -> ring push -> one-ulp ``nextafter`` poke. Re-derives
        ``is_arr`` from the *current* carry, so an earlier poke in the same
        burst correctly hands control back to the round branch."""
        key = self.key
        Q, M = key.max_queue, key.num_models
        inf = self.inf
        ai, qlen, pend, inq, alive, done = (self.ai, self.qlen, self.pend,
                                            self.inq, self.alive, self.done)
        t_arr = self.arr_t.gather(1, ai[:, None])[:, 0]
        mdl = self.arr_m.gather(1, ai[:, None])[:, 0]
        t_rnd = pend.amin(1)
        # kind order at equal time: arrival(1) < device-round(2), so the
        # arrival wins ties; failures(0) are the host barriers, which freeze
        # every event with t >= barrier (events *at* the failure time run
        # after it, exactly the reference's (t, kind) order).
        is_arr = t_arr <= t_rnd
        upd_a = is_arr & (t_arr < self.barrier) & ~self.over

        elig = self.place_t.index_select(0, mdl) & alive       # [L, G]
        n_elig = elig.sum(1)
        any_elig = n_elig > 0
        single = n_elig == 1
        disp = key.dispatcher
        if disp in ("least-loaded", "stability-aware"):
            # effective_backlog: quantum remainder + drain_estimate's
            # left-to-right per-model fold (bitwise — see drain_tab). A ring
            # that overflowed this step holds Q + 1; its lane stops and the
            # batch is retried, so the lookup only has to stay in bounds.
            remv = torch.where(inq, torch.clamp_min(pend - t_arr[:, None],
                                                    0.0), 0.0)
            qcap = qlen.clamp_max(Q)
            acc = torch.zeros_like(remv)
            for mm in range(M):
                acc = acc + torch.take(self.drain_tab,
                                       self.drain_rows[mm] + qcap[:, :, mm])
            backlog = remv + acc
        if disp == "round-robin":
            rank = elig.to(I64).cumsum(1)
            want = self.rr % n_elig.clamp_min(1) + 1
            pick_multi = (elig & (rank == want[:, None])).to(
                torch.int32).argmax(1)
        elif disp == "jsq":
            qtot = qlen.sum(2)
            pick_multi = torch.where(elig, qtot,
                                     torch.iinfo(torch.int64).max).argmin(1)
        elif disp == "least-loaded":
            pick_multi = torch.where(elig, backlog, inf).argmin(1)
        else:  # stability-aware as a full scan (power_d >= G)
            pred = backlog + self.b1_final_t.index_select(0, mdl)
            pick_multi = torch.where(elig, pred, inf).argmin(1)
        # One eligible device short-circuits the pick (reference
        # `_dispatch`): no argmin, and no round-robin advance. argmin and
        # argmax of an integer mask return the first index on ties, as the
        # reference's do.
        d_pick = torch.where(single, elig.to(torch.int32).argmax(1),
                             pick_multi)
        if disp == "round-robin":
            self.rr.copy_(torch.where(upd_a & any_elig & ~single,
                                      self.rr + 1, self.rr))

        # the reference's .at[...].set/add under vmap: writes at flat
        # indices with an explicit lane offset (one element per lane, no
        # collisions)
        do_push = upd_a & any_elig
        ld = self.lane_g + d_pick                  # (lane, device)
        ldm = ld * M + mdl                         # (lane, device, model)
        len_dm = torch.take(qlen, ldm)
        self.over.copy_(self.over | (do_push & (len_dm >= Q)))
        cell = ldm * Q + (torch.take(self.qhead, ldm) + len_dm) % Q
        self.qarr.put_(cell, torch.where(do_push, t_arr,
                                         torch.take(self.qarr, cell)))
        ew = self.arr_ew.gather(1, ai[:, None])[:, 0]
        self.qew.put_(cell, torch.where(do_push, ew,
                                        torch.take(self.qew, cell)))
        qlen.put_(ldm, len_dm + do_push.to(I64))
        # poke: one-ulp wake unless a quantum is in flight or the device
        # passed the drain cap (eligibility already implies alive)
        can_poke = do_push & ~torch.take(done, ld) & ~torch.take(inq, ld)
        wake = torch.nextafter(t_arr, inf)
        p_old = torch.take(pend, ld)
        pend.put_(ld, torch.where(can_poke, torch.minimum(p_old, wake),
                                  p_old))
        ai.copy_(torch.where(upd_a, ai + 1, ai))
        self.code[row, :, k] = torch.where(
            upd_a, torch.where(any_elig, -(d_pick + 1), 0), 1)
        self.t_out[row, :, k] = t_arr

    def _step(self, row: int) -> None:
        key = self.key
        G, M, E, Q = (key.num_devices, key.num_models, key.num_exits,
                      key.max_queue)
        L, R, K = self.L, self.R, key.burst
        inf = self.inf

        # ---- arrival burst: up to K dispatches before the round ----
        for k in range(K):
            self._arrival_once(row, k)

        pend, inq, qlen, qhead = self.pend, self.inq, self.qlen, self.qhead
        t_arr = self.arr_t.gather(1, self.ai[:, None])[:, 0]
        t_rnd = pend.amin(1)
        d_rnd = pend.argmin(1)
        is_arr = t_arr <= t_rnd
        t_evt = torch.where(is_arr, t_arr, t_rnd)
        frozen = ~(t_evt < self.barrier)
        upd_r = ~frozen & ~self.over & ~is_arr

        # ---- device round: Algorithm 1 on the ring queues ----
        ld = self.lane_g + d_rnd                   # (lane, device)
        ending = torch.take(inq, ld)
        pend.put_(ld, torch.where(upd_r, inf, torch.take(pend, ld)))
        inq.put_(ld, ending & ~upd_r)
        c_old = torch.take(self.clock, ld)
        self.clock.put_(ld, torch.where(upd_r, torch.maximum(c_old, t_rnd),
                                        c_old))
        done_d = torch.take(self.done, ld)
        skip = done_d | (ending & ~torch.take(self.alive, ld))
        over_cap = t_rnd > self.limit
        self.done.put_(ld, done_d | (upd_r & ~skip & over_cap))
        sched_on = upd_r & ~skip & ~over_cap

        ql = qlen.view(L * G, M).index_select(0, ld)           # [L, M]
        qh = qhead.view(L * G, M).index_select(0, ld)
        gather = (qh[:, :, None] + self.ring) % Q               # [L, M, Q]
        warr = self.qarr.view(L * G, M, Q).index_select(0, ld).gather(
            2, gather)
        mask_b = self.pos_q < ql[:, :, None]                    # [L, M, Q]
        # w_max is the FIFO head's wait (QueueSnapshot.w_max): after a
        # failover push the ring is no longer arrival-sorted, and the
        # reference reads the head, not the max.
        w_max = torch.where(ql > 0, t_rnd[:, None] - warr[:, :, 0], 0.0)
        cap = ql.clamp_max(key.max_batch)
        B1 = key.max_batch + 1
        batches = self.ladder.index_select(0, cap.view(-1)).view(L, M, R)
        lat_sel = self.lat_by_cap.view(G * M * B1, E, R).index_select(
            0, ((d_rnd[:, None] * M + self.m_idx) * B1 + cap).view(-1)
        ).view(L, M, E, R)
        wew = (self.qew.view(L * G, M, Q).index_select(0, ld).gather(
            2, gather) if key.factored else None)
        _, m_star, e_star, b_star, has_work, _, _, _ = _score_and_pick(
            self, t_rnd, w_max, batches, lat_sel, mask_b, warr, wew)
        service = torch.take(
            self.exec_lat, ((d_rnd * M + m_star) * E + e_star) * B1 + b_star)
        t_end = t_rnd + service
        is_disp = sched_on & has_work
        ldm = ld * M + m_star                      # (lane, device, model)
        h_old = torch.take(qhead, ldm)
        qhead.put_(ldm, torch.where(is_disp, (h_old + b_star) % Q, h_old))
        qlen.put_(ldm, torch.take(qlen, ldm) - torch.where(is_disp, b_star,
                                                           0))
        self.busy.put_(ld, torch.take(self.busy, ld)
                       + torch.where(is_disp, service, 0.0))
        pend.put_(ld, torch.where(is_disp, t_end, torch.take(pend, ld)))
        inq.put_(ld, torch.take(inq, ld) | is_disp)
        code_r = torch.where(
            is_disp, 2 + d_rnd + G * (m_star + M * (e_star + E * b_star)), 1)

        self.blocked.copy_(self.blocked | frozen | self.over)
        self.code[row, :, K] = torch.where(upd_r, code_r, 1)
        self.t_out[row, :, K] = t_evt


@functools.lru_cache(maxsize=16)
def _cluster_steps(key: _ClusterKey, lanes: int, device: torch.device
                   ) -> _ClusterSteps:
    """One set of static buffers (and, on the card, one captured graph) per
    (static key, lane count, device), reused across calls."""
    return _ClusterSteps(key, lanes, device)


# ---------------------------------------------------------------------------
# Host-side mirror: queue identity, failover, reconstruction
# ---------------------------------------------------------------------------


class _LaneParse:
    """Order bookkeeping for one lane, rebuilt from the emitted step codes.

    ``push[d][m]`` / ``pops[d][m]`` are chronological, and the rings are
    FIFO, so the k-th popped request of a (device, model) pair is its k-th
    pushed one — completions are pure position math, never a re-simulation.
    """

    __slots__ = ("ai", "push", "pops", "stranded", "lost", "dispatched")

    def __init__(self, G: int, M: int):
        self.ai = 0
        self.push: List[List[List[np.ndarray]]] = [
            [[] for _ in range(M)] for _ in range(G)]
        self.pops: List[List[List[Tuple[np.ndarray, ...]]]] = [
            [[] for _ in range(M)] for _ in range(G)]
        self.stranded: List[np.ndarray] = []
        self.lost = 0
        self.dispatched = np.zeros(G, dtype=np.int64)

    def pop_total(self, d: int, m: int) -> int:
        return int(sum(int(p[2].sum()) for p in self.pops[d][m]))

    def queued(self, d: int, m: int) -> np.ndarray:
        """Request indices still queued on (d, m), FIFO order."""
        pushed = (np.concatenate(self.push[d][m])
                  if self.push[d][m] else np.empty(0, np.int64))
        return pushed[self.pop_total(d, m):]


def _parse_chunk(ps: _LaneParse, codes: np.ndarray, ts: np.ndarray,
                 G: int, M: int, E: int, arr_model: np.ndarray) -> None:
    """Fold one chunk's (code, t) stream into the lane mirror (vectorised:
    one boolean-mask pass per touched (device, model) pair)."""
    ev = codes != 1
    if not ev.any():
        return
    codes = codes[ev]
    ts = ts[ev]
    is_a = codes <= 0
    ka = int(is_a.sum())
    # arrival events appear in global arrival order: the j-th one of this
    # chunk is request ps.ai + j.
    if ka:
        acodes = codes[is_a]
        gi = ps.ai + np.arange(ka, dtype=np.int64)
        routed = acodes <= -1
        devs = (-(acodes + 1)).astype(np.int64)
        mods = arr_model[gi]
        if routed.any():
            ps.dispatched += np.bincount(devs[routed], minlength=G)
            pair = devs[routed] * M + mods[routed]
            gir = gi[routed]
            for p in np.unique(pair):
                d, m = divmod(int(p), M)
                ps.push[d][m].append(gir[pair == p])
        if (~routed).any():
            ps.stranded.append(gi[~routed])
            ps.lost += int((~routed).sum())
        ps.ai += ka
    rnd = codes >= 2
    if rnd.any():
        v = (codes[rnd] - 2).astype(np.int64)
        d = v % G
        u = v // G
        m = u % M
        e = (u // M) % E
        b = u // (M * E)
        t = ts[rnd]
        pair = d * M + m
        for p in np.unique(pair):
            dd, mm = divmod(int(p), M)
            sel = pair == p
            ps.pops[dd][mm].append((t[sel], e[sel], b[sel]))


def _host_backlog(d: int, t: float, pend: np.ndarray, inq: np.ndarray,
                  qlen: np.ndarray, drain_tab: np.ndarray, M: int) -> float:
    """numpy mirror of the step's effective_backlog (same IEEE op order)."""
    rem = (max(float(pend[d]) - t, 0.0) if bool(inq[d]) else 0.0)
    acc = 0.0
    for mm in range(M):
        acc = acc + float(drain_tab[d, mm, int(qlen[d, mm])])
    return rem + acc


def _host_fail(ps: _LaneParse, st: dict, d_fail: int, t: float,
               lane: _Lane, ew_lane: np.ndarray, reqid: np.ndarray,
               placement: Sequence[Sequence[int]], dispatcher: str,
               drain_tab: np.ndarray, b1_final: np.ndarray, Q: int,
               M: int) -> bool:
    """Kill ``d_fail`` at barrier time ``t`` and failover its queue through
    the same pick arithmetic the step runs (the numpy mirror uses the same
    IEEE operations as the device pick: a subtraction, a max with 0, a
    left-to-right fold, an add). Mutates the numpy carry views in ``st``
    and the lane mirror. Returns True on ring overflow (caller retries the
    whole run with a wider ring)."""
    alive, done, inq, pend = st["alive"], st["done"], st["inq"], st["pend"]
    qarr, qew, qhead, qlen = st["qarr"], st["qew"], st["qhead"], st["qlen"]
    alive[d_fail] = False
    if not bool(inq[d_fail]):
        pend[d_fail] = np.inf
    orphans = []
    for m in range(M):
        idxs = ps.queued(d_fail, m)
        if len(idxs):
            orphans.append(idxs)
        # truncate the mirror to the consumed prefix; the ring empties
        consumed = ps.pop_total(d_fail, m)
        pushed = (np.concatenate(ps.push[d_fail][m])
                  if ps.push[d_fail][m] else np.empty(0, np.int64))
        ps.push[d_fail][m] = [pushed[:consumed]] if consumed else []
        qlen[d_fail, m] = 0
    if not orphans:
        return False
    orph = np.concatenate(orphans)
    order = np.lexsort((reqid[orph], lane.arrival[orph]))
    orph = orph[order]
    wake = np.nextafter(t, np.inf)
    for ridx in orph:
        ridx = int(ridx)
        m = int(lane.model[ridx])
        elig = [dd for dd in placement[m] if bool(alive[dd])]
        if not elig:
            ps.stranded.append(np.array([ridx], dtype=np.int64))
            ps.lost += 1
            continue
        if len(elig) == 1:
            pick = elig[0]
        elif dispatcher == "round-robin":
            pick = elig[st["rr"] % len(elig)]
            st["rr"] += 1
        elif dispatcher == "jsq":
            pick = min(elig, key=lambda dd: (int(qlen[dd].sum()), dd))
        elif dispatcher == "least-loaded":
            pick = min(elig, key=lambda dd: (
                _host_backlog(dd, t, pend, inq, qlen, drain_tab, M), dd))
        else:  # stability-aware full scan
            pick = min(elig, key=lambda dd: (
                _host_backlog(dd, t, pend, inq, qlen, drain_tab, M)
                + float(b1_final[dd, m]), dd))
        if int(qlen[pick, m]) >= Q:
            return True  # ring overflow: retry wider
        slot = (int(qhead[pick, m]) + int(qlen[pick, m])) % Q
        qarr[pick, m, slot] = lane.arrival[ridx]
        qew[pick, m, slot] = ew_lane[ridx]
        qlen[pick, m] += 1
        ps.push[pick][m].append(np.array([ridx], dtype=np.int64))
        ps.dispatched[pick] += 1
        if not bool(done[pick]) and not bool(inq[pick]):
            pend[pick] = min(float(pend[pick]), wake)
    return False


def _fail_over(plan: "_ClusterPlan", steps: "_ClusterSteps",
               parse: List[_LaneParse], bt: float, dying: Sequence[int],
               dispatcher: str, drain_tab: np.ndarray, Q: int) -> bool:
    """The host's fail-over barrier at ``bt``: the carry comes to the host,
    each lane's ``dying`` devices hand their queues to the numpy mirror of
    the pick, and the carry goes back. True when a ring overflowed (the
    batch then retries wider and the carry is not written back)."""
    st_all = steps.get_carry()
    for li, lane in enumerate(plan.lanes):
        st = {k: st_all[k][li] for k in _NAMES}
        # the round-robin counter continues from the compiled picks; host
        # picks advance it and hand it back
        st["rr"] = int(st_all["rr"][li])
        for d_fail in dying:
            if _host_fail(parse[li], st, d_fail, bt, lane, plan.arr_ew[li],
                          plan.reqids[li], plan.placement, dispatcher,
                          drain_tab, plan.b1_final, Q, plan.num_models):
                return True
        st_all["rr"][li] = st["rr"]
    steps.set_carry(st_all)
    return False


def _rollup(lane: _Lane, ps: _LaneParse, specs: Sequence[DeviceSpec],
            cfg: SchedulerConfig, exec_lat: np.ndarray, reqid: np.ndarray,
            clock_row: np.ndarray, busy_row: np.ndarray,
            qlen_row: np.ndarray, alive_row: np.ndarray, horizon: float,
            warmup_tasks: int, keep_completions: bool) -> ClusterResult:
    """Reference-identical rollup: merged (finish, req_id) completion order,
    shared-span utilisation, per-device summarize() slices."""
    G = len(specs)
    M = len(lane.tau_vec)
    cols_m, cols_e, cols_b, cols_ri, cols_t0, cols_t1, cols_own = (
        [], [], [], [], [], [], [])
    for d in range(G):
        for m in range(M):
            plist = ps.pops[d][m]
            if not plist:
                continue
            t = np.concatenate([p[0] for p in plist])
            e = np.concatenate([p[1] for p in plist])
            b = np.concatenate([p[2] for p in plist])
            total = int(b.sum())
            pushed = (np.concatenate(ps.push[d][m])
                      if ps.push[d][m] else np.empty(0, np.int64))
            ridx = pushed[:total]
            # finish = t + L(d, m, e, B): the identical IEEE add the step
            # performed when it occupied the quantum.
            fin = t + exec_lat[d, m, e, b]
            cols_m.append(np.full(total, m, dtype=np.int64))
            cols_e.append(np.repeat(e, b))
            cols_b.append(np.repeat(b, b))
            cols_ri.append(ridx)
            cols_t0.append(np.repeat(t, b))
            cols_t1.append(np.repeat(fin, b))
            cols_own.append(np.full(total, d, dtype=np.int64))
    if cols_m:
        model = np.concatenate(cols_m)
        exits = np.concatenate(cols_e)
        batch = np.concatenate(cols_b)
        ridx = np.concatenate(cols_ri)
        disp = np.concatenate(cols_t0)
        fin = np.concatenate(cols_t1)
        own = np.concatenate(cols_own)
        rid = reqid[ridx]
        order = np.lexsort((rid, fin))
        model, exits, batch = model[order], exits[order], batch[order]
        ridx, disp, fin = ridx[order], disp[order], fin[order]
        own, rid = own[order], rid[order]
    else:
        model = exits = batch = ridx = own = rid = np.empty(0, np.int64)
        disp = fin = np.empty(0, np.float64)

    span = max(max(float(c) for c in clock_row), horizon)
    residual = int(qlen_row.sum()) + ps.lost
    busy = sum(float(x) for x in busy_row)
    arrival = lane.arrival[ridx]

    if keep_completions:
        comps = [
            Completion(
                req_id=int(rid[i]), model=int(model[i]),
                arrival=float(arrival[i]), dispatch=float(disp[i]),
                finish=float(fin[i]), exit_idx=int(exits[i]),
                batch_size=int(batch[i]),
                deadline=lane.requests[int(ridx[i])].deadline,
            )
            for i in range(len(model))
        ]
        metrics = summarize(
            comps, specs[0].table, cfg.slo, warmup_tasks=warmup_tasks,
            busy_time=busy, span=span, residual_queue=residual, dropped=0,
        )
    else:
        comps = []
        metrics = summarize_arrays(
            models=model, exits=exits, batches=batch,
            latencies=fin - arrival, queueings=disp - arrival,
            taus=lane.tau_vec[model] if len(model) else np.empty(0),
            table=specs[0].table, warmup_tasks=warmup_tasks,
            busy_time=busy, span=span, residual_queue=residual, dropped=0,
        )

    wu = metrics.warmup_used
    own_done = own[wu:]
    per_dev = []
    for d in range(G):
        sel = own_done == d
        nd = int(sel.sum())
        if keep_completions:
            mine = [c for c, keep in zip(comps[wu:], sel) if keep]
            dm = summarize(mine, specs[d].table, cfg.slo, warmup_tasks=0,
                           dropped=0)
        else:
            dm = summarize_arrays(
                models=model[wu:][sel], exits=exits[wu:][sel],
                batches=batch[wu:][sel],
                latencies=(fin - arrival)[wu:][sel],
                queueings=(disp - arrival)[wu:][sel],
                taus=lane.tau_vec[model[wu:][sel]] if nd else np.empty(0),
                table=specs[d].table, warmup_tasks=0, dropped=0,
            )
        per_dev.append(DeviceMetrics(
            device=d, name=specs[d].label(d), num_completed=nd,
            dispatched=int(ps.dispatched[d]), dropped=0,
            violation_ratio=dm.violation_ratio, p95_latency=dm.p95_latency,
            mean_exit_depth=dm.mean_exit_depth,
            utilization=float(float(busy_row[d]) / span) if span > 0
            else 0.0,
            alive=bool(alive_row[d]),
        ))
    metrics = dataclasses.replace(
        metrics,
        utilization=(busy / (span * G)) if span > 0 else 0.0,
        per_device=tuple(per_dev),
    )
    return ClusterResult(metrics=metrics, completions=comps, span=span,
                         trace=None)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _validate_cluster(specs: Sequence[DeviceSpec], dispatcher: str,
                      power_d: int, tracer, scheds: Sequence[Scheduler],
                      noise_cov: float) -> None:
    G = len(specs)
    if dispatcher not in DISPATCHERS:
        raise ValueError(
            f"unknown dispatcher {dispatcher!r}; "
            f"available: {sorted(DISPATCHERS)}"
        )
    if dispatcher == "stability-aware" and power_d < G:
        raise ScanEngineUnsupported(
            f"stability-aware power-of-d subsampling (power_d={power_d} < "
            f"fleet size {G}) draws numpy Generator.choice samples with no "
            f"fixed-shape compiled equivalent; the scan engine supports "
            f"stability-aware only as a full scan (power_d >= fleet size) "
            f"— use the Python ClusterSimulator for true power-of-d"
        )
    if tracer is not None:
        raise ScanEngineUnsupported(
            "the cluster scan engine does not reconstruct telemetry "
            "timelines (a documented loud reject) — trace cluster runs "
            "with the Python ClusterSimulator"
        )
    if noise_cov > 0:
        raise ScanEngineUnsupported(
            "service-time noise draws per-quantum RNG the compiled step "
            "does not reproduce; use the Python engine"
        )
    E = specs[0].table.num_exits
    for d, spec in enumerate(specs):
        if spec.drift is not None:
            raise ScanEngineUnsupported(
                f"device {d} carries a DriftModel; per-device drift needs "
                f"the Python ClusterSimulator"
            )
        if spec.table.num_exits != E:
            raise ScanEngineUnsupported(
                f"device {d} has {spec.table.num_exits} exits but device 0 "
                f"has {E}; the compiled lattice is one fixed [E] axis"
            )
    for sched in scheds:
        _validate_scheduler(sched)


@dataclasses.dataclass
class _ClusterPlan:
    """One cluster batch's host-side inputs: everything the step needs but
    the ring width, which the overflow retry doubles."""

    specs: List[DeviceSpec]
    cfg: SchedulerConfig
    scheds: List[Scheduler]
    lanes: List[_Lane]
    placement: List[List[int]]
    reqids: List[np.ndarray]
    segments: List[Tuple[float, List[int]]]   # (barrier, dying devices)
    num_fails: int
    n_qmax: int           # densest per-model arrival count of any lane
    n_total_max: int      # longest lane
    budget: int           # the event bound
    fixed: dict           # the static key's fields that stay put
    exec_lat: np.ndarray
    lat_by_cap: np.ndarray
    b1_final: np.ndarray
    place: np.ndarray
    tau_vec: np.ndarray
    arr_t: np.ndarray
    arr_m: np.ndarray
    arr_ew: np.ndarray
    limit: float

    @property
    def num_devices(self) -> int:
        return len(self.specs)

    @property
    def num_models(self) -> int:
        return self.fixed["num_models"]

    @property
    def num_exits(self) -> int:
        return self.fixed["num_exits"]

    def first_window(self, max_queue: Optional[int]) -> int:
        return max_queue or min(_MAX_QUEUE_DEFAULT,
                                _pow2(max(self.n_qmax, 1)))

    def key(self, max_queue: int) -> _ClusterKey:
        return _ClusterKey(max_queue=max_queue, **self.fixed)

    def load(self, steps: "_ClusterSteps") -> np.ndarray:
        """Copy the inputs into ``steps``' static buffers, set the initial
        carry and the first segment's barrier; returns the drain table
        (``[G, M, Q+1]``) the host's fail-over mirror also reads."""
        G, M, Q = self.num_devices, self.num_models, steps.key.max_queue
        L = len(self.lanes)
        drain_tab = np.zeros((G, M, Q + 1), dtype=np.float64)
        for d, s in enumerate(self.scheds):
            for m in range(M):
                for q in range(1, Q + 1):
                    drain_tab[d, m, q] = drain_cell(s, m, q)
        steps.load(self.arr_t, self.arr_m, self.arr_ew, self.lat_by_cap,
                   self.exec_lat, drain_tab, self.b1_final, self.tau_vec,
                   self.place, self.limit)
        steps.set_carry({
            "ai": np.zeros(L, np.int64),
            "qarr": np.zeros((L, G, M, Q), np.float64),
            "qew": np.zeros((L, G, M, Q), np.float64),
            "qhead": np.zeros((L, G, M), np.int64),
            "qlen": np.zeros((L, G, M), np.int64),
            "pend": np.full((L, G), np.inf, np.float64),
            "inq": np.zeros((L, G), bool),
            "alive": np.ones((L, G), bool),
            "done": np.zeros((L, G), bool),
            "clock": np.zeros((L, G), np.float64),
            "busy": np.zeros((L, G), np.float64),
            "rr": np.zeros(L, np.int64),
            "blocked": np.zeros(L, bool),
            "over": np.zeros(L, bool),
        })
        steps.barrier.fill_(self.segments[0][0])
        return drain_tab


def _plan_cluster(devices: Sequence[DeviceSpec], arrival_lanes,
                  horizon: float, policy: str,
                  config: Optional[SchedulerConfig], dispatcher: str,
                  power_d: int, num_models: Optional[int], drain_cap: float,
                  factored: Optional[bool], service_noise_cov: float,
                  tracer: Optional[Tracer]) -> _ClusterPlan:
    specs = list(devices)
    G = len(specs)
    assert G >= 1
    cfg = config or SchedulerConfig()
    M = num_models or specs[0].table.num_models
    scheds = [make_scheduler(policy, s.table, cfg) for s in specs]
    _validate_cluster(specs, dispatcher, power_d, tracer, scheds,
                      service_noise_cov)
    placement = [
        [d for d, s in enumerate(specs)
         if s.models is None or m in s.models]
        for m in range(M)
    ]
    for m, hosts in enumerate(placement):
        assert hosts, f"model {m} is placed on no device"

    lanes = [_unpack_lane(lane, M, cfg.slo) for lane in arrival_lanes]
    tau_vec = lanes[0].tau_vec if lanes else np.full(M, cfg.slo)
    for lane in lanes[1:]:
        if not np.array_equal(lane.tau_vec, tau_vec):
            raise ScanEngineUnsupported(
                "all lanes of one cluster scan batch must share the same "
                "per-model deadline vector (split differing lanes into "
                "separate calls)"
            )

    E = specs[0].table.num_exits
    Bmax = cfg.max_batch
    ladder = _build_ladder(scheds[0], Bmax)
    # Per-device tables: scheduler belief == execution ground truth in the
    # cluster tier (no sched_table / model_map deployment mixing here).
    dense = np.stack([
        _dense_latency(s.table, list(range(M)), E, Bmax) for s in specs
    ])                                                   # [G, M, E, B+1]
    ladder_np = np.array(ladder, dtype=np.int64)
    lat_by_cap = np.ascontiguousarray(np.stack([
        dense[d][:, :, ladder_np].transpose(0, 2, 1, 3) for d in range(G)
    ]))                                                  # [G, M, B+1, E, R]
    b1_final = np.array(
        [[s.table(m, E - 1, 1) for m in range(M)] for s in specs],
        dtype=np.float64,
    )
    place_np = np.zeros((G, M), dtype=bool)
    for m, hosts in enumerate(placement):
        for d in hosts:
            place_np[d, m] = True

    n_total_max = max((len(lane.model) for lane in lanes), default=0)
    n_qmax = max(
        (max((len(ix) for ix in lane.by_model), default=0)
         for lane in lanes),
        default=0,
    )
    last_arrival = max(
        (lane.arrival[-1] for lane in lanes if len(lane.arrival)),
        default=0.0,
    )
    if factored is None:
        factored = bool(last_arrival / tau_vec.min() <= _FACTORED_RANGE)

    reqids = [
        np.arange(len(lane.requests), dtype=np.int64)
        if isinstance(lane.requests, TraceColumns)   # req_id == row index
        else np.fromiter(map(operator.attrgetter("req_id"), lane.requests),
                         dtype=np.int64, count=len(lane.requests))
        for lane in lanes
    ]
    fails = sorted(
        (float(s.fail_at), d) for d, s in enumerate(specs)
        if s.fail_at is not None
    )
    barrier_groups: List[Tuple[float, List[int]]] = []
    for tf, d in fails:
        if barrier_groups and barrier_groups[-1][0] == tf:
            barrier_groups[-1][1].append(d)
        else:
            barrier_groups.append((tf, [d]))
    L = len(lanes)
    P = _pow2(n_total_max + 1)
    budget = (4 + 3 * len(fails)) * max(n_total_max, 1) + 4 * G + 64

    arr_t = np.full((L, P), np.inf, dtype=np.float64)
    arr_m = np.zeros((L, P), dtype=np.int64)
    arr_ew = np.zeros((L, P), dtype=np.float64)
    for li, lane in enumerate(lanes):
        n = len(lane.model)
        arr_t[li, :n] = lane.arrival
        arr_m[li, :n] = lane.model
        if factored:
            arr_ew[li, :n] = np.exp(-lane.arrival / tau_vec[lane.model])

    fixed = dict(
        num_devices=G, num_models=M, num_exits=E, pad_len=P,
        chunk_steps=min(_pow2(budget), 256), burst=_BURST, max_batch=Bmax,
        ladder=ladder, allowed=tuple(e in scheds[0]._exits for e in range(E)),
        fallback_exit=scheds[0]._exits[0], clip=cfg.clip, factored=factored,
        dispatcher=dispatcher,
    )
    return _ClusterPlan(
        specs=specs, cfg=cfg, scheds=scheds, lanes=lanes,
        placement=placement, reqids=reqids,
        segments=barrier_groups + [(np.inf, [])], num_fails=len(fails),
        n_qmax=n_qmax, n_total_max=n_total_max, budget=budget, fixed=fixed,
        exec_lat=dense, lat_by_cap=lat_by_cap, b1_final=b1_final,
        place=place_np, tau_vec=tau_vec, arr_t=arr_t, arr_m=arr_m,
        arr_ew=arr_ew, limit=horizon + drain_cap,
    )


def simulate_cluster_scan_batch(
    devices: Sequence[DeviceSpec],
    arrival_lanes: Sequence[Sequence[Request]],
    horizon: float,
    policy: str = "edgeserving",
    config: Optional[SchedulerConfig] = None,
    dispatcher: str = "least-loaded",
    power_d: int = 2,
    num_models: Optional[int] = None,
    warmup_tasks: int = 100,
    seed: int = 0,
    drain_cap: float = 600.0,
    max_queue: Optional[int] = None,
    keep_completions: bool = True,
    factored: Optional[bool] = None,
    service_noise_cov: float = 0.0,
    tracer: Optional[Tracer] = None,
    device: DeviceLike = None,
) -> List[ClusterResult]:
    """Run one cluster experiment per arrival lane, all lanes side by side
    in one lane-batched float64 step — the compiled twin of
    ``ClusterSimulator(devices, ...).run(lane, horizon)`` (``seed`` is
    accepted for signature parity; the supported family draws no RNG).
    Returns one :class:`ClusterResult` per lane, in order. Unsupported
    features raise :class:`ScanEngineUnsupported`; see the module docstring
    for the dispatcher matrix and the failover protocol.

    ``keep_completions=False`` skips building per-request ``Completion``
    objects and computes the identical metrics through ``summarize_arrays``
    — the seed-band path uses this to stay vectorised at 10^3 lanes.
    ``device``: ``None`` runs the lanes on the card (raising where there is
    none), ``"cpu"`` runs the same step eagerly on the host.
    """
    with _timed("plan"):
        plan = _plan_cluster(devices, arrival_lanes, horizon, policy,
                             config, dispatcher, power_d, num_models,
                             drain_cap, factored, service_noise_cov, tracer)
    dev = resolve_device(device)
    lanes = plan.lanes
    if not lanes:
        return []
    G, M, E = plan.num_devices, plan.num_models, plan.num_exits
    L = len(lanes)
    Q = plan.first_window(max_queue)
    while True:
        key = plan.key(Q)
        S = key.chunk_steps
        steps = _cluster_steps(key, L, dev)
        with _timed("plan"):
            drain_tab = plan.load(steps)
        parse = [_LaneParse(G, M) for _ in lanes]
        overflowed = False
        steps_run = 0
        step_cap = plan.budget + (len(plan.segments) + 2) * S
        for bt, dying in plan.segments:
            # fresh segment: clear the barrier-freeze flags
            steps.blocked.zero_()
            steps.barrier.fill_(bt)
            while True:
                with _timed("steps"):
                    blocks = [steps.advance()
                              for _ in range(S // steps.graph_steps)]
                    # [S, L, K+1] slots flatten to the execution-order
                    # event stream the mirror expects
                    codes = torch.cat([b[0] for b in blocks]).transpose(
                        0, 1).cpu().numpy()
                    tvals = torch.cat([b[1] for b in blocks]).transpose(
                        0, 1).cpu().numpy()
                    blocked = steps.blocked.cpu().numpy()
                    over = steps.over.cpu().numpy()
                steps_run += S
                with _timed("parse"):
                    for li in range(L):
                        _parse_chunk(parse[li], codes[li].reshape(-1),
                                     tvals[li].reshape(-1), G, M, E,
                                     plan.arr_m[li])
                if bool(over.any()):
                    overflowed = True
                    break
                if bool(blocked.all()):
                    break
                if steps_run > step_cap:
                    raise RuntimeError(
                        f"cluster scan exceeded its step budget "
                        f"({steps_run} events for {plan.n_total_max} "
                        f"arrivals, {plan.num_fails} failures); this "
                        f"indicates a termination bug — please report"
                    )
            if overflowed:
                break
            if not dying:
                continue
            with _timed("fail-over"):
                overflowed = _fail_over(plan, steps, parse, bt, dying,
                                        dispatcher, drain_tab, Q)
            if overflowed:
                break
        if overflowed:
            if Q >= max(plan.n_qmax, 1):
                raise RuntimeError(
                    "cluster scan overflowed a ring already as large as "
                    "the densest per-model arrival count — please report"
                )
            Q *= 2  # retry with a wider ring (sticky-flag overflow)
            continue
        break

    fin = steps.get_carry()
    results = []
    with _timed("rollup"):
        for li, lane in enumerate(lanes):
            assert parse[li].ai == len(lane.model), \
                "arrival stream not drained"
            results.append(_rollup(
                lane, parse[li], plan.specs, plan.cfg, plan.exec_lat,
                plan.reqids[li], fin["clock"][li], fin["busy"][li],
                fin["qlen"][li], fin["alive"][li], horizon, warmup_tasks,
                keep_completions,
            ))
    return results


def simulate_cluster_scan(
    devices: Sequence[DeviceSpec],
    arrivals: Sequence[Request],
    horizon: float,
    **kwargs,
) -> ClusterResult:
    """Compiled twin of ``ClusterSimulator(devices, ...).run(arrivals,
    horizon)`` for one trace: same arguments-to-metrics contract, one
    lane-batched step loop instead of the Python global event loop. See
    :func:`simulate_cluster_scan_batch` for the supported feature matrix
    (``device=`` included)."""
    return simulate_cluster_scan_batch(
        devices, [arrivals], horizon, **kwargs)[0]
