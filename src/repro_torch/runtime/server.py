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

from repro_torch.core.adaptive import OnlineProfiler
from repro_torch.core.metrics import summarize
from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot, ServiceQueue
from repro_torch.core.request import Completion, Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.telemetry import Tracer, decision_margin
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models.resnet import EarlyExitResNet, ResNetConfig
from repro_torch.models import LMConfig, build_model


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


def lm_payload(cfg: LMConfig, generator: torch.Generator, prompt_len: int,
               max_batch: int) -> Dict[str, torch.Tensor]:
    """One served batch of ``max_batch`` rows for ``cfg``'s family, drawn
    on the generator's device: ``{"tokens": [B, prompt_len]}`` for a
    decoder-only model, ``{"embeds": [B, frontend_seq, D]}`` for one with
    the vision frontend stub, ``{"src_embeds": [B, frontend_seq, D],
    "tokens": [B, prompt_len]}`` for the encoder-decoder. With
    ``models.common.meta_generator()`` the batch is shapes only, on
    ``meta`` (what the roofline counts)."""
    device = generator.device
    shape_only = torch.device(device).type == "meta"

    def embeds():
        shape = (max_batch, cfg.frontend_seq, cfg.d_model)
        if shape_only:
            return torch.empty(shape, dtype=cfg.dtype, device=device)
        return torch.randn(shape, generator=generator,
                           device=device).to(cfg.dtype)

    def tokens():
        shape = (max_batch, prompt_len)
        if shape_only:
            return torch.empty(shape, dtype=torch.int64, device=device)
        return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                             device=device)

    if cfg.family == "encdec":
        return {"src_embeds": embeds(), "tokens": tokens()}
    if cfg.frontend == "vision":
        return {"embeds": embeds()}
    return {"tokens": tokens()}


def serve_lms(configs: Mapping[str, LMConfig], device: DeviceLike = None,
              seed: int = 0, prompt_len: int = 128,
              max_batch: int = 8) -> List[ServedModel]:
    """The early-exit LM deployment: one model per config (any family,
    through ``build_model``), in the order given, as
    ``examples/serve_multi_model.py`` serves them.

    Model ``i``'s weights come from a generator seeded ``seed + i`` on the
    device itself, and its payload is a slice of one ``max_batch``-row
    batch (:func:`lm_payload`) drawn once on the device from the same
    generator, so a quantum times the forward and not a host copy. A
    quantum is ``exit_decision``: the trunk through exit e, then the fused
    exit-head kernel on the last position, giving (token, max logit,
    logsumexp).
    """
    device = resolve_device(device)
    served = []
    for i, (name, cfg) in enumerate(configs.items()):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        model = build_model(cfg, generator=gen, device=device).eval()
        payload = lm_payload(cfg, gen, prompt_len, max_batch)
        served.append(ServedModel(
            name=name, values=model,
            forward_fn=lambda mod, batch, e: mod.exit_decision(batch, e),
            data_fn=lambda b, _p=payload: {k: v[:b] for k, v in _p.items()},
            num_exits=cfg.num_exits))
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
    whatever the wall clock says. ``profiler`` (optional) is a
    ``repro_torch.core.adaptive.OnlineProfiler``: every quantum's measured
    service time is folded into it and the scheduler's table is swapped for
    its refreshed view on the profiler's cadence (and, unlike the
    simulator, not restored when a run ends). ``tracer`` (optional) is a
    record-only ``repro_torch.core.telemetry.Tracer``. With both ``None`` a
    run is the stock run.
    """

    def __init__(
        self,
        models: Sequence[ServedModel],
        scheduler: Scheduler,
        clock: Callable[[], float] = time.monotonic,
        profiler: Optional[OnlineProfiler] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.models = list(models)
        self.scheduler = scheduler
        self.clock = clock
        self.profiler = profiler
        # Record-only telemetry: live runs emit the same decision/span/event
        # vocabulary as the simulators, so one tools/tracestats.py
        # invocation reads either. None = zero cost.
        self.tracer = tracer
        self.queues = [ServiceQueue(m) for m in range(len(models))]
        self.completions: List[Completion] = []
        self.dropped = 0
        self._busy_s = 0.0
        self._unsubmitted = 0  # trace tail never ingested (drain-cap exit)
        # Engine counters, cumulative across run() calls like the completion
        # log; "engine-counters" trace events snapshot them at each run()
        # exit. stalls = idle rounds that slept.
        self.counters: Dict[str, int] = {
            "batches_served": 0,
            "requests_served": 0,
            "stalls": 0,
            "profiler_refreshes": 0,
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

        With a ``profiler`` attached, each quantum's measured wall-clock
        service feeds ``OnlineProfiler.ingest_quantum`` and the scheduler's
        table is refreshed in place on the profiler's cadence.
        """
        t0 = self.clock()
        next_arr = 0
        n = len(arrivals)
        self._unsubmitted = 0
        tracer = self.tracer
        slo = self.scheduler.config.slo
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
                popped = self.queues[m].pop_batch(cnt)
                n_shed = len(popped)
                self.dropped += n_shed
                self.counters["dropped"] += n_shed
                if tracer is not None:
                    for req in popped:
                        tracer.record_drop(req, now, slo)
                    if n_shed:
                        tracer.record_event(now, "shed", n=n_shed)
                if self.profiler is not None:
                    self.profiler.observe_dropped(n_shed)
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
            if tracer is not None:
                tracer.record_decision(
                    t_dispatch, decision, t_done,
                    tuple(snapshot.qlens()),
                    tuple(snapshot.w_max(m)
                          for m in range(len(self.queues))),
                    margin=decision_margin(self.scheduler, snapshot),
                )
            for req in batch:
                self.completions.append(Completion(
                    req_id=req.req_id, model=req.model, arrival=req.arrival,
                    dispatch=t_dispatch, finish=t_done,
                    exit_idx=decision.exit_idx,
                    batch_size=decision.batch_size,
                    deadline=req.deadline,
                ))
                if tracer is not None:
                    tracer.record_completion(
                        req, t_dispatch, t_done, decision.exit_idx,
                        decision.batch_size, slo)
            if self.profiler is not None:
                refreshed = self.profiler.ingest_quantum(
                    decision.model, decision.exit_idx, decision.batch_size,
                    t_done - t_dispatch, t_done, batch,
                    self.scheduler.config.slo)
                if refreshed is not None:
                    self.scheduler.table = refreshed
                    self.counters["profiler_refreshes"] += 1
                    if tracer is not None:
                        tracer.record_refresh(t_done, self.profiler)
        t_exit = self.clock() - t0
        self.counters["drain_residual"] = (
            sum(len(q) for q in self.queues) + self._unsubmitted)
        if tracer is not None:
            tracer.record_event(t_exit, "engine-counters", **self.counters)
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

    def trace(self, **meta):
        """Freeze the attached tracer's timeline as a ``telemetry.Trace``
        (``None`` when no tracer is attached). Unlike the simulators the
        engine is long-lived, so the caller decides when to snapshot;
        residual-span accounting covers whatever is still queued now."""
        if self.tracer is None:
            return None
        slo = self.scheduler.config.slo
        for q in self.queues:
            for req in q.pending():
                self.tracer.record_residual(req, slo, device=-1)
        base = dict(engine="live", num_models=len(self.models),
                    num_devices=1, slo=slo)
        base.update(meta)
        return self.tracer.freeze(**base)
