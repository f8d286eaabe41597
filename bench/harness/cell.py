"""One run of one cell: set-up, the measured window, the traced stretch,
the metrics and the comparison that decides ``correct``.

Set-up (``setup_s``): the deployment drawn from the seed, the port's
offline profile (``measure_profile`` at its defaults over the
configuration's profiled batches), the scheduler (``edgeserving`` with the
``cuda`` scoring backend), every reachable (model, exit, batch) warmed by
``ServingEngine.warmup``, the arrival trace generated. The window drives
``ServingEngine.run`` over the trace for ``seconds``, then drains for at
most ``DRAIN_CAP_S``; what is still queued then has failed. Every metric
of the host's clock, the per-layer ones too, is read from the window.

With ``trace``, the same engine then serves a stretch of ``STRETCH_S``
seconds more of the same traffic (fresh arrivals from the seed) under
``torch.profiler``, and the device's metrics are read from it: tracing
slows the host's launches, so the window itself is never traced. The
comparison that decides ``correct`` covers the window and the stretch.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import SchedulerConfig, make_scheduler
from repro_torch.core.queues import QueueSnapshot
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.runtime.server import (ServingEngine, measure_profile,
                                        run_quantum)

from harness import check, deploy, launches, summary, tracing
from harness import traffic as traffic_gen

DRAIN_CAP_S = 1.0
OUTPUT_GAPS = ("token_gap", "lse_gap", "max_gap")  # check.output_gaps
STRETCH_S = 10.0   # the traced stretch served after the window (at most
TRACE_AT = 0.1     # as long); its reduced part starts at this share of it
TRACE_S = 8.0      # and lasts this long (at most 80% of it)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    config: dict
    summary: dict
    per_model: list
    setup_s: float
    profile_s: float
    table: object
    round_seconds: List[float]
    trace: Optional[dict]
    checks: list            # (name, value, limit)
    arrivals: int
    memory_peak_bytes: int
    sample_rows: int = 0
    control: Optional[tuple] = None  # (token, lse, max gaps) of the control

    @property
    def control_correct(self) -> Optional[bool]:
        """Whether the float8 control, in the program's place, passes."""
        if self.control is None:
            return None
        limits = self.config["limits"]
        return all(v <= limits[name]
                   for name, v in zip(OUTPUT_GAPS, self.control))

    @property
    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.checks)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             fault: Optional[Callable] = None,
             control: bool = False) -> RunRecord:
    on_card = device.type == "cuda"
    slo = config["slo_ms"] * 1e-3
    max_batch = config["max_batch"]

    # -- set-up --------------------------------------------------------------
    t0 = time.perf_counter()
    dep = deploy.build(config, seed, device)
    dep.recorder.fault = fault
    if on_card:
        torch.cuda.synchronize(device)
    _log(f"set-up: deployment drawn in {time.perf_counter() - t0:.2f} s")
    n_exits = dep.served[0].num_exits
    t0 = time.perf_counter()
    table = measure_profile(dep.served, batch_sizes=config["profile_batches"],
                            exit_names=[f"exit{e}" for e in range(n_exits)])
    profile_s = time.perf_counter() - t0
    sched = make_scheduler("edgeserving", table, SchedulerConfig(
        slo=slo, max_batch=max_batch, backend="cuda",
        device=None if on_card else "cpu"))
    engine = ServingEngine(dep.served, sched)
    t0 = time.perf_counter()
    engine.warmup()
    _warm_scoring(sched, len(dep.served), max_batch)
    _log(f"set-up: profile {profile_s:.2f} s, warm-up "
         f"{time.perf_counter() - t0:.2f} s")
    rates = traffic_gen.model_rates(traffic, config["knee_req_s"],
                                    [m["share"] for m in config["models"]])
    arrivals = traffic_gen.arrivals(traffic, rates, seconds, seed)

    rounds, round_s = [], []
    state = {"prune_s": 0.0, "t0": 0.0, "marks": 0, "tracing": False}
    spans = tracing.Spans()
    prune, decide = sched.prune, sched.decide
    stretch_s = min(STRETCH_S, seconds)
    trace_at = TRACE_AT * stretch_s
    trace_end = trace_at + min(TRACE_S, 0.8 * stretch_s)

    def timed_prune(snapshot):
        t = time.perf_counter()
        out = prune(snapshot)
        state["prune_s"] = time.perf_counter() - t
        return out

    def timed_decide(snapshot):
        if state["tracing"] and state["marks"] < 2:
            now = time.monotonic() - state["t0"]
            if now >= (trace_at, trace_end)[state["marks"]]:
                spans.mark(tracing.MARKS[state["marks"]])
                state["marks"] += 1
        t = time.perf_counter()
        d = decide(snapshot)
        dt = time.perf_counter() - t
        if d is not None and dep.recorder.on:
            rounds.append((snapshot, d))
            round_s.append(dt + state["prune_s"])
        return d

    sched.prune, sched.decide = timed_prune, timed_decide

    # -- the window -----------------------------------------------------------
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    reset_launch_counts()
    dep.recorder.on = True
    state["t0"] = time.monotonic()
    completions, _ = engine.run(arrivals, seconds, drain=True,
                                drain_cap=DRAIN_CAP_S)
    window = list(completions)
    window_round_s = list(round_s)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # what the drain cap left is the window's (failed); the stretch starts
    # with empty queues
    left = sum(len(q.pop_batch(len(q))) for q in engine.queues)
    left += engine._unsubmitted

    # -- the traced stretch (--trace 1), after the window ---------------------
    trace_out, stretch = None, []
    primed = dict.fromkeys(launches.KERNELS, 0)
    if trace:
        stretch = traffic_gen.arrivals(traffic, rates, stretch_s,
                                       deploy.derive_seed(seed, 4),
                                       first_id=len(arrivals))
        sched.prune = spans.wrap(sched.prune, "prune")
        sched.decide = spans.wrap(sched.decide, "decide")
        engine.submit = spans.wrap(engine.submit, "ingest")
        engine._execute = spans.wrap(
            engine._execute, lambda m, e, b: f"quantum/{m}/{e}/{b}")
        prof = torch.profiler.profile(activities=_activities(on_card))
        dep.recorder.on = False
        before = {k: launch_counts[k] for k in launches.KERNELS}
        prof.start()
        run_quantum(dep.served[0], 0, 1)  # the profiler's first events
        primed = {k: launch_counts[k] - before[k] for k in launches.KERNELS}
        dep.recorder.on = True
        state["t0"], state["tracing"] = time.monotonic(), True
        completions, _ = engine.run(stretch, stretch_s, drain=True,
                                    drain_cap=DRAIN_CAP_S)
        state["tracing"] = False
        t = time.perf_counter()
        prof.stop()
        _log(f"profiler stopped in {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        dtype_bytes = [dep.weights[m]["embed"].element_size()
                       for m in range(len(dep.served))]
        trace_out = tracing.reduce(
            list(tracing.device_rows(prof)) + spans.rows, dep.lms,
            config["prompt_len"], dtype_bytes)
        del prof
        _log(f"trace read in {time.perf_counter() - t:.2f} s")
    dep.recorder.on = False
    launched = {k: launch_counts[k] - primed[k] for k in launches.KERNELS}

    # -- metrics: the window's ------------------------------------------------
    lat = [c.finish - c.arrival for c in window]
    summ = summary.summarize(
        len(arrivals), lat, [c.dispatch - c.arrival for c in window],
        [c.exit_idx for c in window], [c.batch_size for c in window],
        [slo] * len(window), seconds)
    counts = np.bincount([r.model for r in arrivals],
                         minlength=len(dep.served))
    per_model = summary.per_model(
        [c.model for c in window], lat, [c.exit_idx for c in window],
        [slo] * len(window), counts.tolist(), seconds)

    queued = sum(len(q) for q in engine.queues)
    acct = check.accounting_errors(
        len(arrivals) + len(stretch), completions, engine.dropped,
        left + queued, engine._unsubmitted if trace else 0,
        sum(d.batch_size for _, d in rounds))
    want = launches.implied(dep.lms, [(d.model, d.exit_idx)
                                      for _, d in rounds], len(rounds))

    # -- the program's state is freed; then the reference --------------------------
    clip = sched.config.clip
    del engine, sched, completions
    dep.served.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(deploy.derive_seed(seed, 3))
    sample = check.sample_quanta(dep.recorder.quanta, config["check_rows"],
                                 rng)
    t0 = time.perf_counter()
    gaps = check.output_gaps(dep, sample, control)
    _log(f"reference: {time.perf_counter() - t0:.2f} s")
    n_rows = sum(q.batch for q in sample)
    limits = config["limits"]
    checks = [(name, v, limits[name])
              for name, v in zip(OUTPUT_GAPS, gaps["program"])]
    checks += [
        ("decision_errors",
         check.decision_errors(rounds, table, slo, max_batch, clip), 0),
        ("accounting_errors", acct, 0),
    ]
    if on_card:
        checks.insert(4, ("launch_errors",
                          check.launch_errors(launched, want), 0))
    _log(f"launches {launched} implied {want}")
    _log(f"sample: {len(sample)} quanta of {len(dep.recorder.quanta)}, "
         f"{n_rows} rows, {len({(q.model, q.exit_idx, q.batch) for q in dep.recorder.quanta})} "
         f"(model, exit, batch) served")
    return RunRecord(config=config, summary=summ, per_model=per_model,
                     setup_s=setup_s, profile_s=profile_s, table=table,
                     round_seconds=window_round_s, trace=trace_out,
                     checks=checks,
                     arrivals=len(arrivals), memory_peak_bytes=int(peak),
                     sample_rows=n_rows, control=gaps.get("control"))


def _warm_scoring(sched, n_models: int, max_batch: int) -> None:
    """Score a few snapshots before the window, so that the scoring
    kernel is built and loaded and its staging buffers sized (up to 32
    batches a queue) in set-up, not in the first rounds served."""
    for q in (1, max_batch, 8 * max_batch, 32 * max_batch):
        waits = [np.linspace(0.02, 0.0, q) for _ in range(n_models)]
        sched.decide(QueueSnapshot(0.0, waits))


def _activities(on_card: bool) -> Sequence:
    """The device alone where there is one (the CPU in the tests)."""
    return [torch.profiler.ProfilerActivity.CUDA if on_card
            else torch.profiler.ProfilerActivity.CPU]
