"""EdgeServing core on PyTorch: queues, profile tables, the Algorithm-1
scheduler and its baselines, scoring backends, traffic and metrics.

Host bookkeeping stays numpy float64, op for op the reference's
(``src/repro/core``); what the reference computes in jnp or Pallas runs here
as float32 torch tensors or the CUDA kernel.
"""

from repro_torch.core.baselines import SCHEDULERS, make_scheduler
from repro_torch.core.metrics import ModelMetrics, ServingMetrics, summarize
from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot, ServiceQueue
from repro_torch.core.request import Completion, Decision, Request, ServingTrace
from repro_torch.core.scheduler import (
    EdgeServingScheduler,
    LatticeEdgeServingScheduler,
    Scheduler,
    SchedulerConfig,
    VectorizedEdgeServingScheduler,
)
from repro_torch.core.scoring import SCORING_BACKENDS, make_scoring_backend
from repro_torch.core.traffic import paper_rate_vector, poisson_arrivals
from repro_torch.core.workloads import ArrivalProcess, PoissonProcess

__all__ = [
    "ArrivalProcess", "Completion", "Decision", "EdgeServingScheduler",
    "LatticeEdgeServingScheduler", "ModelMetrics", "PoissonProcess",
    "ProfileTable", "QueueSnapshot", "Request", "SCHEDULERS",
    "SCORING_BACKENDS", "Scheduler", "SchedulerConfig", "ServiceQueue",
    "ServingMetrics", "ServingTrace", "VectorizedEdgeServingScheduler",
    "make_scheduler", "make_scoring_backend", "paper_rate_vector",
    "poisson_arrivals", "summarize",
]
