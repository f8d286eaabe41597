"""EdgeServing core on PyTorch: queues, profile tables, the Algorithm-1
scheduler and its baselines, scoring backends, the workload scenarios,
online adaptation, the event-driven serving simulator, the sweep harness
and metrics.

Host bookkeeping stays numpy float64, op for op the reference's
(``src/repro/core``); what the reference computes in jnp or Pallas runs here
as float32 torch tensors or the CUDA kernel.
"""

from repro_torch.core.adaptive import (
    DRIFTS,
    AdaptConfig,
    ContentionDrift,
    DriftModel,
    DVFSStepDrift,
    OnlineProfiler,
    SafetyController,
    ThermalThrottleDrift,
    make_drift,
    make_profiler,
)
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
from repro_torch.core.simulator import ServingSimulator, SimResult, run_experiment
from repro_torch.core.sweep import SweepResult, SweepRunner, SweepSpec
from repro_torch.core.traffic import paper_rate_vector, poisson_arrivals
from repro_torch.core.workloads import (
    SCENARIOS,
    ArrivalProcess,
    DiurnalProcess,
    FlashCrowdProcess,
    MMPPProcess,
    PoissonProcess,
    TraceReplayProcess,
    burstiness_index,
    interarrival_cov,
    make_scenario,
    record_trace,
)

__all__ = [
    "AdaptConfig", "ArrivalProcess", "Completion", "ContentionDrift",
    "DRIFTS", "DVFSStepDrift", "Decision", "DiurnalProcess", "DriftModel",
    "EdgeServingScheduler", "FlashCrowdProcess",
    "LatticeEdgeServingScheduler", "MMPPProcess", "ModelMetrics",
    "OnlineProfiler", "PoissonProcess", "ProfileTable", "QueueSnapshot",
    "Request", "SCENARIOS", "SCHEDULERS", "SCORING_BACKENDS",
    "SafetyController", "Scheduler", "SchedulerConfig", "ServiceQueue",
    "ServingMetrics", "ServingSimulator", "ServingTrace", "SimResult",
    "SweepResult", "SweepRunner", "SweepSpec", "ThermalThrottleDrift",
    "TraceReplayProcess", "VectorizedEdgeServingScheduler",
    "burstiness_index", "interarrival_cov", "make_drift", "make_profiler",
    "make_scenario", "make_scheduler", "make_scoring_backend",
    "paper_rate_vector", "poisson_arrivals", "record_trace",
    "run_experiment", "summarize",
]
