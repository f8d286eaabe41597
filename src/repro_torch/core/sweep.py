"""Parallel sweep harness for serving experiments.

Every paper figure is a grid sweep — (policy × scenario × seed × rate).
:class:`SweepRunner` fans the grid across worker processes while
guaranteeing that **parallel results are bitwise-identical to serial**:

  * each grid cell is hermetic: the arrival trace, the scheduler and the
    simulator's noise stream are all re-seeded inside the cell from the
    cell's own :class:`SweepSpec` (no shared PRNG stream whose consumption
    order could depend on scheduling);
  * results are returned in grid order regardless of completion order;
  * workers are plain ``ProcessPoolExecutor`` processes using the ``spawn``
    start method. Processes, never threads: ``make_scoring_backend`` keeps
    one instance per (name, device), and the ``cuda`` one owns the staging
    buffers every round reuses.

``ServingMetrics`` is a frozen dataclass of floats/ints/tuples, so
"bitwise-identical" is checked with plain ``==``.

This is the port of the reference's ``src/repro/core/sweep.py``:
single-device cells, fleet cells (``fleet=``, ``cluster_grid``), telemetry
(``trace=True``) and the compiled scan engines (``engine="scan"``:
``repro_torch.core.simfast`` / ``clusterfast``, their lanes on
``SweepSpec.device``).

Typical use::

    runner = SweepRunner(ProfileTable.paper_rtx3080())
    specs = runner.grid(policies=("edgeserving", "all-final"),
                        scenarios=("poisson", "mmpp"),
                        rates=(100.0, 200.0), seeds=(7,))
    results = runner.run(specs, workers=8)   # == runner.run(specs, workers=1)
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import multiprocessing
import os
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.adaptive import AdaptConfig, make_drift
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.cluster import (
    ClusterSimulator,
    make_dispatcher,
    make_fleet,
)
from repro_torch.core.clusterfast import simulate_cluster_scan
from repro_torch.core.metrics import ServingMetrics
from repro_torch.core.profile import ProfileTable
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.simfast import ScanEngineUnsupported, simulate_scan
from repro_torch.core.simulator import ServingSimulator
from repro_torch.core.telemetry import Trace, Tracer
from repro_torch.core.traffic import paper_rate_vector
from repro_torch.core.workloads import make_scenario

__all__ = ["SweepSpec", "SweepResult", "SweepRunner"]


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One hermetic grid cell: everything that varies across a sweep.

    ``rate`` is the paper's scalar traffic intensity (λ₁₅₂), expanded through
    ``paper_rate_vector``; pass an explicit per-model ``rates`` tuple to
    override. ``scenario`` names a ``repro_torch.core.workloads.SCENARIOS``
    entry; ``scenario_kwargs`` (a tuple of (key, value) pairs, to stay
    hashable) parameterises it. ``deadlines`` is an optional per-model SLO
    vector. ``backend`` selects the stability-score scoring engine
    (``repro_torch.core.scoring``: numpy / torch / cuda) for the cell's
    Algorithm-1 scheduler(s) — cluster cells pass it to every per-device
    scheduler — and ``device`` the device the ``torch`` and ``cuda``
    backends score on (None = the card, ``"cpu"`` = their plain versions on
    the host).

    Cluster cells: setting ``fleet`` (a ``repro_torch.core.cluster.FLEETS``
    name) switches the cell from the single-device simulator to a
    :class:`ClusterSimulator` of ``fleet_size`` devices built from the
    runner's table, routed by ``dispatcher``; ``fail_at`` is an optional
    ``((device, time), ...)`` failure schedule. All fields stay hashable /
    picklable, so cluster grids fan across workers with the same
    parallel ≡ serial bitwise guarantee.

    Drift / adaptation (``repro_torch.core.adaptive``): ``drift`` names a
    ``DRIFTS`` model (or ``"none"``) applied to true service times — every
    device of a cluster cell gets its own instance, independently
    re-seeded — with ``drift_kwargs`` as hashable (key, value) pairs;
    ``adapt`` is an optional :class:`AdaptConfig` switching the cell's
    scheduler(s) from the static cold-start table to online-profiled
    refreshes. Both default to off, which is bitwise the stock cell.

    ``trace=True`` attaches a record-only telemetry ``Tracer``: decisions
    and metrics stay bitwise those of the untraced cell, and the result
    carries the frozen :class:`Trace`. ``engine="scan"`` runs the cell
    through the compiled scan engines, which reject loudly
    (``ScanEngineUnsupported``) what they cannot reproduce bitwise.
    ``device`` is also where a scan cell's lanes run.
    """

    policy: str
    scenario: str = "poisson"
    rate: float = 100.0
    seed: int = 7
    slo: float = 0.050
    max_batch: int = 10
    horizon: float = 10.0
    warmup_tasks: int = 100
    rates: Optional[Tuple[float, ...]] = None
    deadlines: Optional[Tuple[float, ...]] = None
    scenario_kwargs: Tuple[Tuple[str, object], ...] = ()
    label: str = ""
    fleet: Optional[str] = None          # None = single-device cell
    fleet_size: int = 1
    dispatcher: str = "least-loaded"
    power_d: int = 2                     # stability-aware power-of-d fan-in
    fail_at: Tuple[Tuple[int, float], ...] = ()
    backend: str = "numpy"
    drift: Optional[str] = None          # DRIFTS name; None/"none" = stock
    drift_kwargs: Tuple[Tuple[str, object], ...] = ()
    adapt: Optional[AdaptConfig] = None  # None = static scheduler table
    engine: str = "python"               # "python" | "scan"
    trace: bool = False                  # attach a telemetry Tracer
                                         # (record-only; decisions/metrics
                                         # stay bitwise-identical)
    device: Optional[str] = None         # scoring / scan device; None = the card

    def rate_vector(self) -> List[float]:
        if self.rates is not None:
            return list(self.rates)
        return paper_rate_vector(self.rate)

    def title(self) -> str:
        if self.label:
            return self.label
        policy = self.policy
        if self.backend != "numpy":
            policy = f"{policy}[{self.backend}]"
        if self.engine != "python":
            policy = f"{policy}[{self.engine}]"
        base = f"{policy}/{self.scenario}/lam{self.rate:g}/seed{self.seed}"
        if self.drift is not None and self.drift != "none":
            base = f"{base}/drift-{self.drift}"
        if self.adapt is not None:
            base = f"{base}/adapt"
        if self.fleet is not None:
            base = f"{self.dispatcher}/{self.fleet}x{self.fleet_size}/{base}"
        return base


@dataclasses.dataclass(frozen=True)
class SweepResult:
    spec: SweepSpec
    metrics: ServingMetrics
    us_per_call: float  # wall microseconds spent on this cell (in its worker)
    trace: Optional[Trace] = None  # telemetry timeline (spec.trace=True)


def _run_cell(runner: "SweepRunner", spec: SweepSpec) -> SweepResult:
    """Module-level trampoline so the pool can pickle the call."""
    return runner.run_cell(spec)


def _check_engine(spec: SweepSpec) -> None:
    """Raise for an unknown engine."""
    if spec.engine not in ("python", "scan"):
        raise ValueError(
            f"unknown SweepSpec.engine {spec.engine!r}; "
            f"expected 'python' or 'scan'"
        )


class SweepRunner:
    """Fans a sweep grid across processes; serial ≡ parallel, bitwise.

    The runner holds the per-sweep invariants (execution table, optional
    restricted scheduler table, deployment map, service-noise CoV); the
    :class:`SweepSpec` holds everything that varies cell to cell. Both are
    picklable, which is the only requirement for the process fan-out.
    """

    def __init__(
        self,
        table: ProfileTable,
        sched_table: Optional[ProfileTable] = None,
        model_map: Optional[Sequence[int]] = None,
        service_noise_cov: float = 0.0,
        data_pool: int = 10_000,
    ):
        self.table = table
        self.sched_table = sched_table
        self.model_map = list(model_map) if model_map is not None else None
        self.service_noise_cov = service_noise_cov
        self.data_pool = data_pool

    # -- grid construction ---------------------------------------------------

    def grid(
        self,
        policies: Sequence[str],
        scenarios: Sequence[str] = ("poisson",),
        rates: Sequence[float] = (100.0,),
        seeds: Sequence[int] = (7,),
        **common,
    ) -> List[SweepSpec]:
        """The full (policy × scenario × rate × seed) product, in that
        nesting order; ``common`` fixes the remaining SweepSpec fields.

        Policies sharing a (scenario, rate, seed) cell see identical arrival
        traces — sweeps are paired comparisons by construction.
        """
        return [
            SweepSpec(policy=p, scenario=sc, rate=r, seed=s, **common)
            for p, sc, r, s in itertools.product(policies, scenarios, rates, seeds)
        ]

    def cluster_grid(
        self,
        dispatchers: Sequence[str],
        fleets: Sequence[Tuple[str, int]],
        scenarios: Sequence[str] = ("poisson",),
        rates: Sequence[float] = (100.0,),
        seeds: Sequence[int] = (7,),
        policy: str = "edgeserving",
        **common,
    ) -> List[SweepSpec]:
        """The (dispatcher × fleet × scenario × rate × seed) cluster product,
        dispatcher-major; ``fleets`` are ``(FLEETS name, size)`` pairs.
        Dispatchers sharing a (fleet, scenario, rate, seed) cell see
        identical arrival traces — paired comparisons by construction.
        """
        return [
            SweepSpec(policy=policy, dispatcher=dp, fleet=fl, fleet_size=fs,
                      scenario=sc, rate=r, seed=s, **common)
            for dp, (fl, fs), sc, r, s in itertools.product(
                dispatchers, fleets, scenarios, rates, seeds)
        ]

    # -- execution -----------------------------------------------------------

    def simulator(self, spec: SweepSpec):
        """The cell's simulator as :meth:`run_cell` runs it: a
        :class:`ServingSimulator` with its scheduler, or for a fleet cell a
        :class:`ClusterSimulator` (for callers that want the run's traces or
        per-device state too). ``spec.trace`` attaches a fresh tracer. A
        scan cell has no simulator object: it runs through
        :meth:`run_cell`."""
        _check_engine(spec)
        if spec.engine == "scan":
            raise ValueError(
                "SweepSpec.engine='scan' cells run through run_cell; the "
                "compiled engines have no simulator object")
        rates = spec.rate_vector()
        cfg = SchedulerConfig(slo=spec.slo, max_batch=spec.max_batch,
                              backend=spec.backend, device=spec.device)
        tracer = Tracer() if spec.trace else None
        if spec.fleet is not None:
            if self.sched_table is not None or self.model_map is not None:
                raise NotImplementedError(
                    "cluster cells build per-device schedulers from the "
                    "fleet's own tables; a runner-level sched_table / "
                    "model_map would be silently ignored — use a "
                    "fleet-less spec or encode the view in the fleet's "
                    "DeviceSpecs via ClusterSimulator directly"
                )
            # One drift instance per device (burst caches are per-instance);
            # ClusterSimulator re-seeds each from (seed, device id).
            fleet_drift = tuple(
                (d, make_drift(spec.drift, **dict(spec.drift_kwargs)))
                for d in range(spec.fleet_size)
            ) if spec.drift not in (None, "none") else ()
            return ClusterSimulator(
                make_fleet(spec.fleet, spec.fleet_size, self.table,
                           fail_at=spec.fail_at, drift=fleet_drift),
                policy=spec.policy,
                config=cfg,
                dispatcher=make_dispatcher(spec.dispatcher, slo=spec.slo,
                                           power_d=spec.power_d),
                num_models=len(rates),
                service_noise_cov=self.service_noise_cov,
                seed=spec.seed,
                adapt=spec.adapt,
                tracer=tracer,
            )
        if (spec.fail_at or spec.fleet_size != 1
                or spec.dispatcher != "least-loaded"):
            raise ValueError(
                "cluster-only SweepSpec fields (fail_at / fleet_size / "
                "dispatcher) require fleet=<FLEETS name>; a single-device "
                "cell would silently ignore them"
            )
        sched = make_scheduler(spec.policy, self.sched_table or self.table,
                               cfg)
        return ServingSimulator(
            sched,
            self.table,
            num_models=len(rates),
            service_noise_cov=self.service_noise_cov,
            model_map=self.model_map,
            seed=spec.seed,
            drift=make_drift(spec.drift, **dict(spec.drift_kwargs)),
            adapt=spec.adapt,
            tracer=tracer,
        )

    def arrivals(self, spec: SweepSpec):
        """The cell's arrival trace, drawn from its own seed."""
        process = make_scenario(
            spec.scenario, spec.rate_vector(), deadlines=spec.deadlines,
            **dict(spec.scenario_kwargs),
        )
        return process.generate(
            spec.horizon, seed=spec.seed, data_pool=self.data_pool
        )

    def run_cell(self, spec: SweepSpec) -> SweepResult:
        """One serving experiment, fully determined by (runner, spec)."""
        t0 = time.perf_counter()
        _check_engine(spec)
        if spec.engine == "scan":
            return self._run_cell_scan(spec, t0)
        sim = self.simulator(spec)
        res = sim.run(self.arrivals(spec), spec.horizon,
                      warmup_tasks=spec.warmup_tasks)
        us = (time.perf_counter() - t0) * 1e6
        return SweepResult(spec, res.metrics, us, trace=res.trace)

    def _run_cell_scan(self, spec: SweepSpec, t0: float) -> SweepResult:
        """``engine="scan"``: the cell through the compiled fast path
        (``repro_torch.core.simfast`` for single-device cells,
        ``repro_torch.core.clusterfast`` when ``spec.fleet`` is set), its
        lanes on ``spec.device``. Decision-equivalent to the Python engine
        for the supported configurations; everything the scan state layouts
        cannot express is rejected loudly here (or by the engines' own
        validation) rather than approximated."""
        unsupported = []
        if spec.drift not in (None, "none"):
            unsupported.append(f"device drift ({spec.drift})")
        if spec.adapt is not None:
            unsupported.append("online profile adaptation")
        if self.service_noise_cov > 0:
            unsupported.append("service-time noise")
        if spec.scenario == "trace-replay":
            unsupported.append("trace replay")
        if spec.backend != "numpy":
            unsupported.append(f"the {spec.backend!r} scoring backend")
        if unsupported:
            raise ScanEngineUnsupported(
                f"SweepSpec.engine='scan' does not support "
                f"{', '.join(unsupported)}; run this cell with the "
                f"Python engine (engine='python')"
            )
        rates = spec.rate_vector()
        cfg = SchedulerConfig(slo=spec.slo, max_batch=spec.max_batch,
                              backend=spec.backend)
        arrivals = self.arrivals(spec)
        if spec.fleet is not None:
            if self.sched_table is not None or self.model_map is not None:
                raise NotImplementedError(
                    "cluster cells build per-device schedulers from the "
                    "fleet's own tables; a runner-level sched_table / "
                    "model_map would be silently ignored — use a "
                    "fleet-less spec or encode the view in the fleet's "
                    "DeviceSpecs via ClusterSimulator directly"
                )
            res = simulate_cluster_scan(
                make_fleet(spec.fleet, spec.fleet_size, self.table,
                           fail_at=spec.fail_at),
                arrivals,
                spec.horizon,
                policy=spec.policy,
                config=cfg,
                dispatcher=spec.dispatcher,
                power_d=spec.power_d,
                num_models=len(rates),
                warmup_tasks=spec.warmup_tasks,
                seed=spec.seed,
                tracer=Tracer() if spec.trace else None,
                device=spec.device,
            )
            us = (time.perf_counter() - t0) * 1e6
            return SweepResult(spec, res.metrics, us, trace=res.trace)
        if (spec.fail_at or spec.fleet_size != 1
                or spec.dispatcher != "least-loaded"):
            raise ValueError(
                "cluster-only SweepSpec fields (fail_at / fleet_size / "
                "dispatcher) require fleet=<FLEETS name>; a single-device "
                "cell would silently ignore them"
            )
        sched = make_scheduler(spec.policy, self.sched_table or self.table,
                               cfg)
        res = simulate_scan(
            sched,
            self.table,
            arrivals,
            spec.horizon,
            num_models=len(rates),
            warmup_tasks=spec.warmup_tasks,
            model_map=self.model_map,
            tracer=Tracer() if spec.trace else None,
            device=spec.device,
        )
        us = (time.perf_counter() - t0) * 1e6
        return SweepResult(spec, res.metrics, us, trace=res.trace)

    def run(
        self, specs: Sequence[SweepSpec], workers: Optional[int] = 1
    ) -> List[SweepResult]:
        """Run the grid; results are in ``specs`` order.

        ``workers=1`` runs serially in-process; ``workers=None`` uses one
        worker per CPU (capped at the grid size). Parallel output is
        bitwise-identical to serial — only ``us_per_call`` (wall timing)
        differs between runs.

        Like any ``spawn``-based multiprocessing client, ``workers > 1``
        needs an importable ``__main__`` (a script or pytest — not a REPL
        heredoc). Each worker builds its own scoring backend, so a cell
        with ``device=None`` initialises the card in its worker.
        """
        specs = list(specs)
        if not specs:
            return []
        if workers is None:
            workers = os.cpu_count() or 1
        workers = max(1, min(int(workers), len(specs)))
        if workers == 1:
            return [self.run_cell(s) for s in specs]
        # spawn, not fork: the parent may hold CUDA state and torch's
        # threads, whose locks a forked child would inherit mid-flight.
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx
        ) as pool:
            futures = [pool.submit(_run_cell, self, s) for s in specs]
            return [f.result() for f in futures]
