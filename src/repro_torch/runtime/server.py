"""Live serving engine: the paper's "GPU runtime" on the card.

Time-division execution of M early-exit models behind FIFO queues, driven
by any ``repro_torch.core`` scheduler. The engine shares queues, snapshots
and metrics with the rest of the core; service time is whatever the wall
clock says while the forward runs on the device.

Offline phase = ``measure_profile`` (wall-clock profile of every (m, e, B)
— the paper's 120-cell table), then ``ServingEngine.run`` is the online
phase. Each quantum is an eager forward under ``torch.inference_mode()``
followed, on CUDA, by ``torch.cuda.synchronize()`` (the reference jits and
blocks until ready). The first call of a shape runs cuDNN's algorithm
choice, so ``warmup`` and ``measure_profile`` run every (m, e, B) before a
served window does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Set)

import numpy as np
import torch

from repro_torch.core.metrics import summarize
from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot, ServiceQueue
from repro_torch.core.request import Completion, Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models.resnet import EarlyExitResNet, ResNetConfig
from repro_torch.models.transformer import DecoderLM, LMConfig


@dataclasses.dataclass
class ServedModel:
    """One deployed early-exit model behind its FIFO queue (paper Sec. III).

    Attributes:
      name:       display/profile-row name (e.g. ``"resnet50"``).
      values:     the model (an ``nn.Module`` or any state) passed to
                  ``forward_fn``.
      forward_fn: ``(values, data, exit_idx) -> outputs`` — one full
                  inference truncated at exit ``exit_idx``.
      data_fn:    ``(batch_size) -> input payload batch`` for profiling and
                  serving quanta.
      num_exits:  number of early-exit heads, shallowest -> deepest.
    """

    name: str
    values: Any
    forward_fn: Callable[[Any, Any, int], Any]
    data_fn: Callable[[int], Any]
    num_exits: int


def output_devices(out) -> Set[torch.device]:
    """The devices of every tensor in ``out`` (a tensor, or tuples, lists
    and dicts of them)."""
    if isinstance(out, torch.Tensor):
        return {out.device}
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(output_devices(o) for o in out))
    return set()


def run_quantum(mod: ServedModel, e: int, b: int):
    """One inference of ``mod`` at exit ``e`` and batch ``b``, finished on
    the device before it returns: every device that holds a tensor of the
    output is synchronised (the reference blocks on the whole output)."""
    with torch.inference_mode():
        out = mod.forward_fn(mod.values, mod.data_fn(b), e)
    for device in output_devices(out):
        synchronize(device)
    return out


def serve_resnets(configs: Mapping[str, ResNetConfig], device: DeviceLike = None,
                  seed: int = 0, max_batch: int = 10) -> List[ServedModel]:
    """The paper's deployment: one :class:`EarlyExitResNet` per config, with
    weights from ``torch.Generator().manual_seed(seed)`` and a payload that
    is a slice of one seeded NHWC image tensor made once on the device, so a
    quantum times the forward and not a host copy."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((max_batch, 32, 32, 3), generator=gen).to(device)
    served = []
    for name, cfg in configs.items():
        model = EarlyExitResNet(cfg, generator=gen, device=device).eval()
        served.append(ServedModel(
            name=name, values=model,
            forward_fn=lambda mod, x, e: mod.forward_exit(x, e),
            data_fn=lambda b: images[:b], num_exits=cfg.num_exits))
    return served


def serve_lms(configs: Mapping[str, LMConfig], device: DeviceLike = None,
              seed: int = 0, prompt_len: int = 128,
              max_batch: int = 8) -> List[ServedModel]:
    """The early-exit LM deployment: one :class:`DecoderLM` per config, in
    order of increasing cost, as ``examples/serve_multi_model.py`` serves
    them.

    Model ``i``'s weights come from a generator seeded ``seed + i`` on the
    device itself, and its payload is a slice of one ``[max_batch,
    prompt_len]`` token tensor drawn once on the device from the same
    generator, so a quantum times the forward and not a host copy. A quantum
    is ``exit_decision``: the trunk through exit e, then the fused exit-head
    kernel on the last position, giving (token, max logit, logsumexp).
    """
    device = resolve_device(device)
    served = []
    for i, (name, cfg) in enumerate(configs.items()):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        model = DecoderLM(cfg, generator=gen, device=device).eval()
        tokens = torch.randint(0, cfg.vocab_size, (max_batch, prompt_len),
                               generator=gen, device=device)
        served.append(ServedModel(
            name=name, values=model,
            forward_fn=lambda mod, x, e: mod.exit_decision({"tokens": x}, e),
            data_fn=lambda b, _t=tokens: _t[:b], num_exits=cfg.num_exits))
    return served


def measure_profile(
    models: Sequence[ServedModel],
    batch_sizes: Sequence[int],
    exit_names: Optional[Sequence[str]] = None,
    accuracy: Optional[np.ndarray] = None,
    repeats: int = 10,
    warmup: int = 2,
    percentile: float = 95.0,
) -> ProfileTable:
    """Offline profiling phase (paper Sec. IV-B) against the live device.

    Records the ``percentile`` wall-clock latency of every (m, e, B) cell
    over ``repeats`` runs after ``warmup`` discarded runs
    (``ProfileTable.measure`` underneath) — the paper's 120-cell table,
    measured rather than calibrated. ``meta["platform"]`` names the device
    the outputs came from (the card's name on CUDA).
    """
    devices = set()

    def run_fn(m: int, e: int, b: int):
        devices.update(output_devices(run_quantum(models[m], e, b)))

    n_exits = models[0].num_exits
    table = ProfileTable.measure(
        [m.name for m in models],
        exit_names or [f"exit{i}" for i in range(n_exits)],
        list(batch_sizes),
        run_fn,
        accuracy=accuracy,
        repeats=repeats,
        warmup=warmup,
        percentile=percentile,
    )
    platform = ",".join(sorted(
        torch.cuda.get_device_name(d) if d.type == "cuda" else d.type
        for d in devices)) or "host"
    return dataclasses.replace(table, meta={**table.meta, "platform": platform})


class ServingEngine:
    """Online serving loop (paper Sec. III "Online Serving Phase").

    The same snapshot -> prune -> decide -> occupy round as the reference's
    engine; each quantum runs the forward on the device and service time is
    whatever the wall clock says.
    """

    def __init__(
        self,
        models: Sequence[ServedModel],
        scheduler: Scheduler,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.models = list(models)
        self.scheduler = scheduler
        self.clock = clock
        self.queues = [ServiceQueue(m) for m in range(len(models))]
        self.completions: List[Completion] = []
        self.dropped = 0
        self._busy_s = 0.0
        self._unsubmitted = 0  # trace tail never ingested (drain-cap exit)
        # Engine counters, cumulative across run() calls like the completion
        # log. stalls = idle rounds that slept.
        self.counters: Dict[str, int] = {
            "batches_served": 0,
            "requests_served": 0,
            "stalls": 0,
            "dropped": 0,
            "drain_residual": 0,
        }

    # -- ingress ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue one request (paper: arrivals are never gated on
        accelerator state; they become visible at the next round)."""
        self.queues[req.model].push(req)

    # -- execution ---------------------------------------------------------------

    def _execute(self, m: int, e: int, b: int):
        return run_quantum(self.models[m], e, b)

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run every (m, e, B) once so that no served quantum is a shape's
        first call.

        ``batch_sizes=None`` derives the reachable batch set from the
        scheduler itself: the union of its candidate ladders over every
        possible queue length up to B_max.
        """
        if batch_sizes is None:
            reach = set()
            for qlen in range(1, self.scheduler.config.max_batch + 1):
                reach.update(self.scheduler.batch_candidates(qlen))
            batch_sizes = sorted(reach)
        for m, mod in enumerate(self.models):
            for e in range(mod.num_exits):
                for b in batch_sizes:
                    self._execute(m, e, b)

    def run(
        self,
        arrivals: Sequence[Request],
        duration: float,
        drain: bool = True,
        idle_sleep: float = 1e-4,
        drain_cap: float = 600.0,
    ) -> "tuple[list[Completion], float]":
        """Serve a pre-generated arrival trace in real time.

        Arrival times in the trace are relative to loop start; requests are
        enqueued when the wall clock passes them. ``drain_cap`` is a hard
        wall-clock cap on post-``duration`` draining; requests stranded at
        the cap stay queued and are surfaced via ``metrics().residual_queue``
        (never-ingested ones too), so completions + dropped + residual
        always equals the arrival count.
        """
        t0 = self.clock()
        next_arr = 0
        n = len(arrivals)
        self._unsubmitted = 0
        while True:
            now = self.clock() - t0
            while next_arr < n and arrivals[next_arr].arrival <= now:
                self.submit(arrivals[next_arr])
                next_arr += 1
            if now > duration + drain_cap:
                self._unsubmitted = n - next_arr
                break
            if now > duration and next_arr >= n:
                if not drain or all(len(q) == 0 for q in self.queues):
                    break
            snapshot = QueueSnapshot.take(self.queues, now)
            for m, cnt in self.scheduler.prune(snapshot):
                n_shed = len(self.queues[m].pop_batch(cnt))
                self.dropped += n_shed
                self.counters["dropped"] += n_shed
            decision = self.scheduler.decide(snapshot)
            if decision is None:
                self.counters["stalls"] += 1
                time.sleep(idle_sleep)
                continue
            batch = self.queues[decision.model].pop_batch(decision.batch_size)
            t_dispatch = self.clock() - t0
            self._execute(decision.model, decision.exit_idx,
                          decision.batch_size)
            t_done = self.clock() - t0
            self._busy_s += t_done - t_dispatch
            self.counters["batches_served"] += 1
            self.counters["requests_served"] += len(batch)
            for req in batch:
                self.completions.append(Completion(
                    req_id=req.req_id, model=req.model, arrival=req.arrival,
                    dispatch=t_dispatch, finish=t_done,
                    exit_idx=decision.exit_idx,
                    batch_size=decision.batch_size,
                    deadline=req.deadline,
                ))
        t_exit = self.clock() - t0
        self.counters["drain_residual"] = (
            sum(len(q) for q in self.queues) + self._unsubmitted)
        return self.completions, t_exit

    def metrics(self, table: ProfileTable, slo: float, span: float,
                warmup_tasks: int = 0):
        """Aggregate the completion log (paper Sec. VI metrics), with queued
        + never-ingested requests surfaced as ``residual_queue`` so
        completions + dropped + residual always equals the arrival count."""
        return summarize(
            self.completions, table, slo, warmup_tasks=warmup_tasks,
            busy_time=self._busy_s, span=span,
            residual_queue=(sum(len(q) for q in self.queues)
                            + self._unsubmitted),
            dropped=self.dropped,
        )
