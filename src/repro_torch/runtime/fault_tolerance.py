"""Fault tolerance for large deployments: preemption handling, elastic
remeshing arithmetic, and straggler mitigation.

  * ``PreemptionGuard`` — SIGTERM/flag-triggered graceful drain: finish the
    in-flight quantum/step, force a checkpoint, exit cleanly.
  * ``ElasticMesh`` — the largest valid (data, model) grid for a surviving
    device count (:meth:`ElasticMesh.propose`), and the torch
    ``DeviceMesh`` of that grid over the job's first ranks
    (:meth:`ElasticMesh.build`).
  * ``StragglerPolicy`` — serving-side mitigation consistent with the
    paper's determinism story: the profile table is scaled by an online
    EWMA of observed/expected latency per replica, so a slow replica's
    queue predictions stay truthful and the stability score automatically
    routes load away from it. (Under time-division there is no intra-step
    collective to desynchronise; stragglers show up as inflated service
    times, which is exactly what the profile multiplier models.)

The failure *detector* is the platform (preemption notices, heartbeats);
these classes consume a simple boolean/callback so any detector can drive
them. Host code, the reference's (``src/repro/runtime/fault_tolerance.py``)
line for line.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import List, Optional

import numpy as np
import torch


class PreemptionGuard:
    """Graceful-drain coordinator.

    Usage:
        guard = PreemptionGuard(install_sigterm=True)
        for step in ...:
            ...train/serve one quantum...
            if guard.should_stop():
                checkpointer.save(step, state); checkpointer.wait(); break
    """

    def __init__(self, install_sigterm: bool = False,
                 deadline_s: Optional[float] = None):
        self._stop = threading.Event()
        self._deadline = (time.monotonic() + deadline_s) if deadline_s else None
        if install_sigterm:
            signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):
        self._stop.set()

    def request_stop(self):
        self._stop.set()

    def should_stop(self) -> bool:
        if self._deadline is not None and time.monotonic() > self._deadline:
            return True
        return self._stop.is_set()


@dataclasses.dataclass
class ElasticMesh:
    """Largest-valid-mesh policy for elastic scaling.

    Given a surviving device count, pick the largest (data, model) grid with
    the model axis preserved (TP degree is fixed by the weight sharding) and
    the data axis shrunk to the largest feasible power-of-two. Training
    semantics are preserved by keeping the *global* batch constant and
    increasing grad-accumulation to cover lost data-parallel rank.
    """

    model_axis: int = 16

    def propose(self, num_devices: int) -> "tuple[int, int, int]":
        """Returns (data_axis, model_axis, grad_accum_multiplier)."""
        assert num_devices >= self.model_axis, (
            "fewer devices than the TP degree: cannot remesh without "
            "re-sharding weights"
        )
        data = num_devices // self.model_axis
        # shrink to a power of two for predictable collectives
        data_pow2 = 1 << (data.bit_length() - 1)
        full_data = 16
        accum = max(1, -(-full_data // data_pow2))
        return data_pow2, self.model_axis, accum

    def build(self, num_devices: Optional[int] = None, device=None):
        """The ``(data, model)`` device mesh of :meth:`propose`'s grid over
        the first ``data * model`` ranks of the job (all of them unless
        ``num_devices`` says how many survive), and the grad-accumulation
        multiplier. Ranks of the default process group are the devices (a
        one-rank group is opened where none is: gloo on the CPU, NCCL on
        the card, which ``device`` picks as ``make_host_mesh`` does)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import make_host_mesh

        if not dist.is_initialized():
            make_host_mesh(1, device=device)
        world = dist.get_world_size()
        n = num_devices if num_devices is not None else world
        data, model, accum = self.propose(n)
        if data * model > world:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                             f"ranks, the job has {world}")
        dev = resolve_device(device)
        ranks = torch.arange(data * model).reshape(data, model)
        mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))
        return mesh, accum


class StragglerPolicy:
    """Per-replica service-time inflation tracking (EWMA of observed /
    profiled latency). The serving router divides each replica's effective
    throughput by its multiplier; the scheduler's profile lookups are scaled
    so stability-score predictions stay truthful on degraded hardware."""

    def __init__(self, num_replicas: int, alpha: float = 0.2,
                 detach_threshold: float = 3.0):
        self.alpha = alpha
        self.detach_threshold = detach_threshold
        self.multipliers = np.ones(num_replicas)

    def observe(self, replica: int, observed_s: float, expected_s: float):
        ratio = max(observed_s / max(expected_s, 1e-9), 1e-3)
        m = self.multipliers[replica]
        self.multipliers[replica] = (1 - self.alpha) * m + self.alpha * ratio

    def healthy(self) -> List[int]:
        return [i for i, m in enumerate(self.multipliers)
                if m < self.detach_threshold]

    def scale_profile(self, replica: int, table):
        """ProfileTable view with this replica's inflation applied."""
        return table.scaled(float(self.multipliers[replica]),
                            name=f"replica{replica}")
