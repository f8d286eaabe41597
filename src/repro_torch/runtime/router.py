"""Multi-replica traffic router: the replica axis of a serving fleet.

Each replica (one card, or a slice of a fleet) runs an independent
EdgeServing instance — the paper's single-accelerator scheduler is the
intra-replica brain; this router is the inter-replica layer:

  * **pluggable dispatch**: replica selection goes through the shared
    ``repro_torch.core.cluster`` :class:`Dispatcher` family (round-robin, JSQ,
    capacity-weighted least-loaded, stability-aware power-of-d) — the same
    implementations the cluster simulator exercises, with the router acting
    as the :class:`DeviceLoadView`. The default remains capacity-weighted
    least-loaded (expected backlog drain time / straggler-scaled capacity),
    which generalises join-shortest-queue to heterogeneous replica speeds;
  * **straggler awareness**: replica capacity weights come from
    ``StragglerPolicy`` EWMA multipliers (observed/expected quantum time),
    so degraded hardware automatically sheds load and detached replicas
    receive none;
  * **locality stickiness**: an optional key (e.g. a conversation id) maps to a
    preferred replica by rendezvous hashing; the router only overrides the
    preference when the preferred replica's backlog exceeds the best one by
    ``spill_factor`` — bounded-load consistent hashing.

The router is deliberately stateless w.r.t. request contents: it reads
only queue backlogs, queue lengths, and capacity weights, all O(replicas)
to maintain. Host code, the reference's (``src/repro/runtime/router.py``)
line for line, rendezvous keys (``hashlib.blake2b``) included.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import (
    DeviceLoadView,
    Dispatcher,
    LeastLoadedDispatcher,
    drain_estimate,
)
from repro_torch.core.profile import ProfileTable
from repro_torch.runtime.fault_tolerance import StragglerPolicy


@dataclasses.dataclass
class ReplicaState:
    """Router-visible state of one serving replica."""

    backlog_s: float = 0.0        # expected time to drain current queues
    healthy: bool = True
    # Last reported per-model queue lengths; None = never reported (the
    # router then derives a count estimate from the backlog instead).
    qlens: Optional[Tuple[int, ...]] = None
    # Requests routed here since the last queue-length report (the greedy
    # in-flight estimate that lets bursts spread under JSQ dispatch too).
    pending: int = 0


class ReplicaRouter(DeviceLoadView):
    def __init__(
        self,
        num_replicas: int,
        straggler: Optional[StragglerPolicy] = None,
        spill_factor: float = 2.0,
        table: Optional[ProfileTable] = None,
        max_batch: int = 10,
        dispatcher: Optional[Dispatcher] = None,
    ):
        """Args:
          table: the replicas' profile table; when given, backlog bumps and
            completion predictions use real per-item service shares instead
            of a placeholder constant.
          max_batch: the serving policy's batch cap B_max (sets the per-item
            share ``L(m, e_final, B_cap) / B_cap``).
          dispatcher: replica-selection policy; default capacity-weighted
            least-loaded (the router's historical behaviour).
        """
        assert num_replicas >= 1
        self.replicas = [ReplicaState() for _ in range(num_replicas)]
        self.straggler = straggler or StragglerPolicy(num_replicas)
        self.spill_factor = spill_factor
        self.table = table
        self.max_batch = max_batch
        self.dispatcher = dispatcher or LeastLoadedDispatcher()
        # Hermeticity (the Dispatcher contract): a router owns its
        # dispatcher's state; reusing one object across routers must not
        # leak RNG/counter state between experiments.
        self.dispatcher.reset(0)
        # Mean per-item service share at the policy's batch cap, final exit
        # (conservative): the backlog a replica gains per routed request.
        if table is not None:
            cap = min(max_batch, table.max_batch)
            e = table.num_exits - 1
            self._service_share = float(np.mean(
                [table(m, e, cap) / cap for m in range(table.num_models)]
            ))
        else:
            self._service_share = 1e-3  # no table: nominal 1 ms placeholder

    # -- state ingestion ------------------------------------------------------

    def update_backlog(self, replica: int, expected_drain_s: float,
                       qlens: Optional[Sequence[int]] = None) -> None:
        """A fresh replica report supersedes the router's greedy in-flight
        estimates (the routed-but-unreported requests are now part of the
        replica's own numbers). A backlog-only report also invalidates any
        earlier queue-length snapshot — keeping a stale ``qlens`` alongside
        a fresh backlog would make JSQ dispatch read two different eras of
        the same replica."""
        self.replicas[replica].backlog_s = expected_drain_s
        self.replicas[replica].pending = 0
        self.replicas[replica].qlens = (
            tuple(int(n) for n in qlens) if qlens is not None else None
        )

    def observe_quantum(self, replica: int, observed_s: float,
                        expected_s: float) -> None:
        """Feed per-quantum timing into the straggler EWMA."""
        self.straggler.observe(replica, observed_s, expected_s)
        healthy = set(self.straggler.healthy())
        for i, r in enumerate(self.replicas):
            r.healthy = i in healthy

    @staticmethod
    def backlog_from_queues(table: ProfileTable, qlens: Sequence[int],
                            exit_idx: Optional[int] = None,
                            max_batch: int = 10) -> float:
        """Expected drain time of a replica's queues at full batches
        (the router's cheap load signal; final exit = conservative)."""
        e = table.num_exits - 1 if exit_idx is None else exit_idx
        total = 0.0
        for m, n in enumerate(qlens):
            full, rem = divmod(n, max_batch)
            total += full * table(m, e, max_batch)
            if rem:
                total += table(m, e, rem)
        return total

    @staticmethod
    def backlog_from_scheduler(scheduler, qlens: Sequence[int],
                               exit_idx: Optional[int] = None) -> float:
        """Policy-aware drain estimate: derives batch sizes from the
        replica scheduler's own candidate ladder (its ``max_batch`` cap,
        its profile table) instead of caller-supplied constants, so a
        replica running e.g. a bs=1 ablation or a small-B_max deployment
        advertises its true (slower) drain time to the router. Closed form
        over the batch ladder (full-batch quotient + remainder rung); see
        ``repro_torch.core.cluster.drain_estimate``.
        """
        return drain_estimate(scheduler, qlens, exit_idx=exit_idx)

    # -- DeviceLoadView (consumed by the shared dispatchers) ------------------

    def healthy(self, i: int) -> bool:
        return self.replicas[i].healthy

    def effective_backlog(self, i: int) -> float:
        """Backlog scaled by the straggler multiplier (slow replica ->
        its queued work takes proportionally longer to drain)."""
        return self.replicas[i].backlog_s * float(
            self.straggler.multipliers[i])

    def total_queued(self, i: int) -> int:
        """Queued-request count for JSQ-style dispatch: the last reported
        queue lengths plus requests routed here since that report (so a
        ``route_batch`` burst spreads under JSQ too). When a replica has
        never reported queue lengths, fall back to the backlog divided by
        the per-item service share (expected count at mean service time;
        the backlog already carries the per-route bumps) so JSQ degrades
        to backlog ordering instead of dogpiling replica 0."""
        r = self.replicas[i]
        if r.qlens is not None:
            return sum(r.qlens) + r.pending
        return int(round(r.backlog_s / self._service_share))

    def predicted_completion(self, i: int, model: int) -> float:
        mult = float(self.straggler.multipliers[i])
        service = (
            self.table(model, self.table.num_exits - 1, 1)
            if self.table is not None else self._service_share
        )
        return self.effective_backlog(i) + service * mult

    # -- routing ---------------------------------------------------------------

    def route(self, key: Optional[str] = None, model: int = 0) -> int:
        """Pick a replica for one request.

        Without a key: dispatcher policy over healthy replicas (default:
        capacity-weighted least-loaded). With a key: rendezvous-hash
        preference, spilled to the least-loaded replica only when the
        preferred one is ``spill_factor``x worse. The keyed path never
        consults the dispatcher, so stateful dispatchers (round-robin
        counter, power-of-d RNG) advance only for requests they route.
        """
        healthy = [i for i, r in enumerate(self.replicas) if r.healthy]
        if not healthy:  # total failure: degrade to round-robin over all
            healthy = list(range(len(self.replicas)))
        if key is None:
            return self.dispatcher.pick(model, healthy, self)
        preferred = max(
            healthy,
            key=lambda i: hashlib.blake2b(
                f"{key}|{i}".encode(), digest_size=8).digest(),
        )
        best = min(healthy, key=lambda i: (self.effective_backlog(i), i))
        pref_load = self.effective_backlog(preferred)
        best_load = self.effective_backlog(best)
        if pref_load <= self.spill_factor * max(best_load, 1e-9):
            return preferred
        return best

    def route_batch(self, n: int, key_prefix: Optional[str] = None,
                    model: int = 0) -> List[int]:
        """Route n requests, refreshing the load view greedily per request
        (each assignment bumps the chosen replica's backlog estimate by its
        per-item service share — ``mean_m L(m, e_final, B_cap) / B_cap``
        from the profile table when available — so a burst spreads correctly
        even on slow fleets instead of dogpiling)."""
        out = []
        if not any(r.healthy for r in self.replicas):
            return [i % len(self.replicas) for i in range(n)]
        for j in range(n):
            i = self.route(f"{key_prefix}:{j}" if key_prefix else None,
                           model=model)
            out.append(i)
            self.replicas[i].backlog_s += self._service_share
            self.replicas[i].pending += 1
        return out
