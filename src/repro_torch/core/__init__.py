"""EdgeServing core on PyTorch: queues, profile tables, the Algorithm-1
scheduler and its baselines, scoring backends, the workload scenarios,
online adaptation, the event-driven serving simulator, the cluster tier
(fleets, dispatchers, per-device metrics), telemetry, the sweep harness and
metrics.

Host bookkeeping stays numpy float64, op for op the reference's
(``src/repro/core``); what the reference computes in jnp or Pallas runs here
as float32 torch tensors or the CUDA kernel. The compiled scan tiers
(``simfast``, ``clusterfast``) run one fixed-shape float64 step over many
lanes, replayed as CUDA graphs on the card; ``seedband`` puts confidence
bands on their per-seed columns.
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
from repro_torch.core.cluster import (
    DISPATCHERS,
    FLEETS,
    ClusterResult,
    ClusterSimulator,
    DeviceLoadView,
    DeviceSpec,
    Dispatcher,
    JoinShortestQueueDispatcher,
    LeastLoadedDispatcher,
    RoundRobinDispatcher,
    StabilityAwareDispatcher,
    drain_cell,
    drain_estimate,
    make_dispatcher,
    make_fleet,
)
from repro_torch.core.clusterfast import (
    SUPPORTED_DISPATCHERS,
    simulate_cluster_scan,
    simulate_cluster_scan_batch,
)
from repro_torch.core.metrics import (
    DeviceMetrics,
    ModelMetrics,
    ServingMetrics,
    summarize,
    summarize_arrays,
)
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
from repro_torch.core.seedband import (
    BandSummary,
    GapSummary,
    SeedBandResult,
    compare_bands,
    simulate_cluster_scan_seedband,
    simulate_scan_seedband,
    summarize_band,
)
from repro_torch.core.simfast import (
    ScanEngineUnsupported,
    simulate_scan,
    simulate_scan_batch,
)
from repro_torch.core.simulator import ServingSimulator, SimResult, run_experiment
from repro_torch.core.sweep import SweepResult, SweepRunner, SweepSpec
from repro_torch.core.telemetry import (
    EVENT_KINDS,
    DecisionRecord,
    RequestSpan,
    TimelineMetrics,
    Trace,
    TraceEvent,
    Tracer,
    decision_margin,
    export_chrome_trace,
    export_ndjson,
    load_ndjson,
    timeline_metrics,
)
from repro_torch.core.traffic import paper_rate_vector, poisson_arrivals
from repro_torch.core.workloads import (
    SCENARIOS,
    ArrivalProcess,
    DiurnalProcess,
    FlashCrowdProcess,
    MMPPProcess,
    PoissonProcess,
    TraceColumns,
    TraceReplayProcess,
    burstiness_index,
    columns_from_requests,
    interarrival_cov,
    make_scenario,
    record_trace,
)

__all__ = [
    "AdaptConfig", "ArrivalProcess", "BandSummary", "ClusterResult",
    "ClusterSimulator", "Completion", "ContentionDrift", "DISPATCHERS",
    "DRIFTS", "DVFSStepDrift", "Decision", "DecisionRecord",
    "DeviceLoadView", "DeviceMetrics", "DeviceSpec", "Dispatcher",
    "DiurnalProcess", "DriftModel", "EVENT_KINDS", "EdgeServingScheduler",
    "FLEETS", "FlashCrowdProcess", "GapSummary",
    "JoinShortestQueueDispatcher", "LatticeEdgeServingScheduler",
    "LeastLoadedDispatcher", "MMPPProcess", "ModelMetrics",
    "OnlineProfiler", "PoissonProcess", "ProfileTable", "QueueSnapshot",
    "Request", "RequestSpan", "RoundRobinDispatcher", "SCENARIOS",
    "SCHEDULERS", "SCORING_BACKENDS", "SUPPORTED_DISPATCHERS",
    "SafetyController", "ScanEngineUnsupported", "Scheduler",
    "SchedulerConfig", "SeedBandResult", "ServiceQueue", "ServingMetrics",
    "ServingSimulator", "ServingTrace", "SimResult",
    "StabilityAwareDispatcher", "SweepResult", "SweepRunner", "SweepSpec",
    "ThermalThrottleDrift", "TimelineMetrics", "Trace", "TraceColumns",
    "TraceEvent", "TraceReplayProcess", "Tracer",
    "VectorizedEdgeServingScheduler", "burstiness_index",
    "columns_from_requests", "compare_bands", "decision_margin",
    "drain_cell", "drain_estimate", "export_chrome_trace", "export_ndjson",
    "interarrival_cov", "load_ndjson", "make_dispatcher", "make_drift",
    "make_fleet", "make_profiler", "make_scenario", "make_scheduler",
    "make_scoring_backend", "paper_rate_vector", "poisson_arrivals",
    "record_trace", "run_experiment", "simulate_cluster_scan",
    "simulate_cluster_scan_batch", "simulate_cluster_scan_seedband",
    "simulate_scan", "simulate_scan_batch", "simulate_scan_seedband",
    "summarize", "summarize_arrays", "summarize_band", "timeline_metrics",
]
