"""The traced stretch: after the measured window, the engine serves a
stretch more under ``torch.profiler``, which records the device's
operations from before the stretch to after it (so that neither its start
nor its stop stalls what is reduced), and a fixed part inside it is
reduced to busy and idle time, the operations that took most device time,
the idle gaps by what the host was doing, and each kernel's time beside
the least time of the calls the trace holds.

The profiler traces the device alone: recording every host operation
would slow the host's launches several fold. Even so, tracing the device
slows them, which is why the measured window is never traced. The
host's side is the benchmark's own spans, taken on the clock the
profiler's device timestamps use (Unix nanoseconds): ``ingest`` (the
engine's ``submit``), ``prune`` and ``decide`` (the scheduler),
``quantum/<m>/<e>/<b>`` (``run_quantum`` through its synchronise), and the
marks ``stretch_start`` and ``stretch_end`` which bound the stretch. A
kernel belongs to the quantum whose span holds its start: the quantum
launches it and waits for it.

The profiler now and then loses kernel events. A quantum whose
flash-attention or exit-head kernels are not all in the trace is left out
of that kernel's sums, and the count kept is reported.
"""

from __future__ import annotations

import bisect
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Sequence,
                    Tuple)

import torch

from costs.kernels import call_cost, quantum_calls
from costs.model import quantum_flops
from costs.peaks import least_seconds

MARKS = ("stretch_start", "stretch_end")
EXIT_HEAD_LAUNCHES = 2  # pass 1 and the fold, one call


def kernel_class(name: str) -> str:
    for key in ("flash_attention", "exit_head"):
        if key in name:
            return key
    return "other"


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Spans:
    """The benchmark's host spans, in microseconds on the Unix clock."""

    def __init__(self):
        self.rows: List[Tuple[str, bool, float, float]] = []

    def wrap(self, fn: Callable, name) -> Callable:
        rows, clock = self.rows, time.time_ns

        def wrapped(*args):
            t = clock()
            try:
                return fn(*args)
            finally:
                label = name(*args) if callable(name) else name
                rows.append((label, False, t * 1e-3, clock() * 1e-3))
        return wrapped

    def mark(self, name: str) -> None:
        t = time.time_ns() * 1e-3
        self.rows.append((name, False, t, t))


def device_rows(prof) -> Iterator[Tuple[str, bool, float, float]]:
    """``(name, True, start, end)`` in microseconds of a stopped profiler's
    device operations, read from the Kineto events directly (parsing every
    event into a ``FunctionEvent`` takes far longer)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            yield e.name(), True, e.start_ns() * 1e-3, e.end_ns() * 1e-3


def reduce(events: Iterable[Tuple[str, bool, float, float]],
           lms: Sequence[dict], prompt_len: int,
           dtype_bytes: Sequence[int]) -> dict:
    """Reduce the device's rows and the host's spans to the trace's
    numbers, in seconds."""
    kernels, host, marks = [], [], {}
    for name, on_device, a, b in events:
        if on_device:
            kernels.append((a, b, name))
        elif name in MARKS:
            marks[name] = a
        else:
            host.append((a, b, name))
    t0 = marks.get("stretch_start", min((k[0] for k in kernels), default=0))
    t1 = marks.get("stretch_end", max((k[1] for k in kernels), default=0))
    kernels = [k for k in kernels if k[0] >= t0 and k[1] <= t1]
    host = [h for h in host if h[1] >= t0 and h[0] <= t1]
    busy = _union([(a, b) for a, b, _ in kernels])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = {}
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        covered = 0.0
        j = max(bisect.bisect_left(starts, a) - 1, 0)
        while j < len(host) and host[j][0] < b:
            ha, hb, name = host[j]
            j += 1
            part = min(b, hb) - max(a, ha)
            if part > 0:
                label = "quantum" if name.startswith("quantum/") else name
                gaps[label] = gaps.get(label, 0.0) + part
                covered += part
        if b - a > covered:  # no span: the engine loop between rounds
            gaps["poll"] = gaps.get("poll", 0.0) + (b - a - covered)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    quanta = [h for h in host
              if h[2].startswith("quantum/") and h[0] >= t0 and h[1] <= t1]
    q_starts = [q[0] for q in quanta]
    per_q: List[Dict[str, List[float]]] = [dict() for _ in quanta]
    for a, b, name in kernels:
        i = bisect.bisect_right(q_starts, a) - 1
        if i >= 0 and a <= quanta[i][1]:
            per_q[i].setdefault(kernel_class(name), []).append(b - a)
    sums = {k: {"seconds": 0.0, "least_seconds": 0.0, "calls": 0,
                "quanta_kept": 0, "quanta": len(quanta)}
            for k in ("flash_attention", "exit_head")}
    flops = q_seconds = 0.0
    for (a, b, name), got in zip(quanta, per_q):
        _, m, e, bsz = name.split("/")
        m, e, bsz = int(m), int(e), int(bsz)
        flops += quantum_flops(lms[m], e, bsz, prompt_len)
        q_seconds += (b - a) * 1e-6
        calls = quantum_calls(lms[m], e, bsz, prompt_len)
        for kernel in sums:
            mine = [c for c in calls if c[0] == kernel]
            want = len(mine) * (EXIT_HEAD_LAUNCHES if kernel == "exit_head"
                                else 1)
            times = got.get(kernel, [])
            if len(times) != want:
                continue
            s = sums[kernel]
            s["seconds"] += sum(times) * 1e-6
            s["least_seconds"] += sum(
                least_seconds(*call_cost(k, shape, dtype_bytes[m]))
                for k, shape in mine)
            s["calls"] += len(mine)
            s["quanta_kept"] += 1
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": [[n[:120], s * 1e-6] for n, s in device_ops],
        "idle_gaps": [[n, s * 1e-6] for n, s in idle_gaps],
        "kernels": sums,
        "quanta": len(quanta),
        "quanta_flops": flops,
        "quanta_seconds": q_seconds,
        "kernel_events": len(kernels),
    }
