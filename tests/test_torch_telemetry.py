"""The port's telemetry against the JAX reference's on the CPU.

With the ``numpy`` scoring backend the simulator, the tracer and the
exporters are host code in both packages, op for op, so for the same run
the port's decision records (scores and margins included), request spans,
events and meta must equal the reference's with ``==`` (NaN compared as
NaN), and ``export_ndjson`` / ``export_chrome_trace`` must write files
byte-identical to the reference's. ``tools/tracestats.py`` must read the
port's files as they are.

Under the ``cuda`` backend (here on ``device="cpu"``, through the
stability kernel's plain version) ``decision_margin`` re-scores in float32,
so the exports are byte-identical only for ``numpy`` runs: there decisions
and spans stay equal and margins agree to the float32 tolerance of the
reference's scoring backends (``src/repro/core/scoring.py:25-27``).

Fixed seeds and rates replace the reference's hypothesis draws; nothing
here reads the wall clock.
"""

import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro_torch.core import (
    ProfileTable,
    SchedulerConfig,
    ServingSimulator,
    SweepRunner,
    SweepSpec,
    Tracer,
    decision_margin,
    export_chrome_trace,
    export_ndjson,
    load_ndjson,
    make_scheduler,
    paper_rate_vector,
    poisson_arrivals,
    timeline_metrics,
)

from torch_compare import plain

REPO = pathlib.Path(__file__).resolve().parent.parent
TRACESTATS = REPO / "tools" / "tracestats.py"
HORIZON = 2.0
# (policy, lambda_152, seed): the three policy families of the tracer
# (greedy, lattice, and symphony's sheds with NaN margins) at a knee and
# an overload, over two seeds
CASES = [
    ("edgeserving", 110.0, 7),
    ("edgeserving", 220.0, 0),
    ("edgeserving-lattice", 140.0, 3),
    ("edgeserving-lattice", 240.0, 7),
    ("symphony", 220.0, 7),
    ("symphony", 160.0, 1),
]
CASE_IDS = [f"{p}-lam{lam:g}-seed{s}" for p, lam, s in CASES]
F32_RTOL = 1e-5  # the float32 backends' score tolerance (scoring.py:25-27)


def _run(pkg, policy, lam, seed, tracer=None, horizon=HORIZON, **cfg):
    table = pkg.ProfileTable.paper_rtx3080()
    sched = pkg.make_scheduler(policy, table, pkg.SchedulerConfig(**cfg))
    sim = pkg.ServingSimulator(sched, table, num_models=3, seed=seed,
                               tracer=tracer)
    arrivals = pkg.poisson_arrivals(paper_rate_vector(lam), horizon,
                                    seed=seed)
    return sim.run(arrivals, horizon, warmup_tasks=20), len(arrivals)


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def pair(request):
    policy, lam, seed = request.param
    port, n = _run(P, policy, lam, seed, tracer=Tracer())
    ref, _ = _run(R, policy, lam, seed, tracer=R.Tracer())
    return port, ref, n


def test_traced_run_equals_the_reference(pair):
    port, ref, n = pair
    assert plain(port.trace.decisions) == plain(ref.trace.decisions)
    assert plain(port.trace.spans) == plain(ref.trace.spans)
    assert plain(port.trace.events) == plain(ref.trace.events)
    assert port.trace.meta == ref.trace.meta
    assert plain(port.metrics) == plain(ref.metrics)
    assert len(port.trace.spans) == n == sum(port.trace.span_counts().values())
    assert port.trace.span_counts() == ref.trace.span_counts()
    assert port.trace.num_devices == 1
    assert port.trace.end_time() == ref.trace.end_time()


@pytest.mark.parametrize("fmt", ["ndjson", "chrome"])
def test_exports_are_byte_identical_to_the_reference(pair, tmp_path, fmt):
    port, ref, _ = pair
    write, ref_write = ((export_ndjson, R.export_ndjson) if fmt == "ndjson"
                        else (export_chrome_trace, R.export_chrome_trace))
    got, want = tmp_path / "port", tmp_path / "ref"
    assert write(port.trace, str(got)) == str(got)
    ref_write(ref.trace, str(want))
    assert got.read_bytes() == want.read_bytes()


def test_ndjson_round_trips(pair, tmp_path):
    port, _, _ = pair
    path, again = str(tmp_path / "a.ndjson"), str(tmp_path / "b.ndjson")
    export_ndjson(port.trace, path)
    back = load_ndjson(path)
    export_ndjson(back, again)
    assert open(path).read() == open(again).read()
    assert plain(back.decisions) == plain(port.trace.decisions)
    assert plain(back.spans) == plain(port.trace.spans)
    assert back.meta == port.trace.meta
    ref_back = R.load_ndjson(path)
    assert plain(ref_back.events) == plain(back.events)


@pytest.mark.parametrize("num_bins", [1, 7, 40])
def test_timeline_bins_sum_back_and_equal_the_reference(pair, num_bins):
    port, ref, _ = pair
    got = timeline_metrics(port.trace, num_bins=num_bins)
    want = R.timeline_metrics(ref.trace, num_bins=num_bins)
    assert got.aggregate_violation_ratio() == port.metrics.violation_ratio
    assert int(got.completed.sum()) == port.metrics.num_completed
    assert int(got.dropped.sum()) == port.metrics.dropped
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    np.testing.assert_array_equal(got.centers, want.centers)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tracer_none_is_bitwise_the_traced_run(case):
    policy, lam, seed = case
    traced, _ = _run(P, policy, lam, seed, tracer=Tracer())
    untraced, _ = _run(P, policy, lam, seed)
    assert untraced.trace is None
    assert plain(untraced.metrics) == plain(traced.metrics)
    assert plain(untraced.completions) == plain(traced.completions)
    assert untraced.span == traced.span


@pytest.mark.parametrize("fmt", ["ndjson", "chrome"])
def test_tracestats_reads_the_ports_files(tmp_path, fmt):
    res, _ = _run(P, "symphony", 220.0, 7, tracer=Tracer())
    path = str(tmp_path / ("t.ndjson" if fmt == "ndjson" else "t.json"))
    (export_ndjson if fmt == "ndjson" else export_chrome_trace)(res.trace,
                                                                path)
    out = subprocess.run(
        [sys.executable, str(TRACESTATS), path, "--top", "3", "--bins", "5"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    assert "per-model decisions" in out.stdout
    assert "worst 3 requests" in out.stdout
    assert f"dropped={res.metrics.dropped}" in out.stdout


def test_rerun_resets_the_tracer():
    tracer = Tracer()
    table = ProfileTable.paper_rtx3080()
    sched = make_scheduler("edgeserving", table, SchedulerConfig())
    sim = ServingSimulator(sched, table, num_models=3, seed=7, tracer=tracer)
    arrivals = poisson_arrivals(paper_rate_vector(150.0), 1.0, seed=7)
    first = sim.run(arrivals, 1.0, warmup_tasks=20).trace
    second = sim.run(arrivals, 1.0, warmup_tasks=20).trace
    assert plain(first) == plain(second)
    assert len(tracer.spans) == len(arrivals)


def test_decision_margin_families():
    """NaN outside the scored family, inf for one candidate, the gap
    between the two best scores otherwise — equal to the reference's for
    every registered policy."""
    table, ref_table = (ProfileTable.paper_rtx3080(),
                        R.ProfileTable.paper_rtx3080())
    arrivals = poisson_arrivals(paper_rate_vector(200.0), 0.3, seed=5)

    def snapshots(pkg, reqs):
        full = [pkg.ServiceQueue(m) for m in range(3)]
        for r in reqs:
            full[r.model].push(pkg.Request(r.req_id, r.model, r.arrival))
        single = [pkg.ServiceQueue(m) for m in range(3)]
        single[0].push(pkg.Request(0, 0, 0.1))
        return (pkg.QueueSnapshot.take(full, 0.3),
                pkg.QueueSnapshot.take(single, 0.3))

    snap, one = snapshots(P, arrivals)
    ref_snap, ref_one = snapshots(R, arrivals)
    scored = []
    for policy in P.SCHEDULERS:
        sched = make_scheduler(policy, table, SchedulerConfig())
        ref = R.make_scheduler(policy, ref_table, R.SchedulerConfig())
        for s, rs in ((snap, ref_snap), (one, ref_one)):
            assert (plain(decision_margin(sched, s))
                    == plain(R.decision_margin(ref, rs))), policy
        if not math.isnan(decision_margin(sched, snap)):
            scored.append(policy)
            assert decision_margin(sched, snap) >= 0.0
            assert decision_margin(sched, one) == float("inf")
    # the registered members of the scored family (the vectorised
    # scheduler is the fifth, and has no registry name)
    assert scored == ["edgeserving", "edgeserving-lattice",
                      "allfinal-deadline-aware", "ours-bs1"]
    vec = P.VectorizedEdgeServingScheduler(table, SchedulerConfig())
    assert decision_margin(vec, snap) == R.decision_margin(
        R.VectorizedEdgeServingScheduler(ref_table, R.SchedulerConfig()),
        ref_snap)


def test_cuda_backend_margins_to_float32_tolerance(tmp_path):
    """The ``cuda`` backend re-scores each traced round in float32: its
    decisions and spans equal the ``numpy`` run's, its margins agree to the
    float32 tolerance, and only the ``numpy`` run's exports are pinned to
    the reference's bytes."""
    f64, _ = _run(P, "edgeserving-lattice", 240.0, 7, tracer=Tracer())
    f32, _ = _run(P, "edgeserving-lattice", 240.0, 7, tracer=Tracer(),
                  backend="cuda", device="cpu")
    assert plain(f32.trace.spans) == plain(f64.trace.spans)
    assert len(f32.trace.decisions) == len(f64.trace.decisions)
    scores = []
    for a, b in zip(f32.trace.decisions, f64.trace.decisions):
        assert (a.t, a.t_end, a.model, a.exit_idx, a.batch_size,
                a.queue_depths, a.oldest_ages) == (
            b.t, b.t_end, b.model, b.exit_idx, b.batch_size,
            b.queue_depths, b.oldest_ages)
        scores.append((a.score, b.score, a.margin, b.margin))
    got = np.array(scores)
    finite = np.isfinite(got[:, 3])
    np.testing.assert_array_equal(np.isfinite(got[:, 2]), finite)
    np.testing.assert_allclose(got[:, 0], got[:, 1], rtol=F32_RTOL, atol=0)
    # a margin is the runner-up's score minus the winner's: its float32
    # error is at most the two scores' errors, each within the tolerance
    win, margin = got[finite, 1], got[finite, 3]
    bound = F32_RTOL * (np.abs(win) + np.abs(win + margin))
    assert np.all(np.abs(got[finite, 2] - margin) <= bound)


def test_sweep_trace_flag_attaches_and_defaults_off():
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    ref_runner = R.SweepRunner(R.ProfileTable.paper_rtx3080())
    base = dict(policy="edgeserving", rate=110.0, seed=7, horizon=1.5,
                warmup_tasks=20)
    off = runner.run_cell(SweepSpec(**base))
    on = runner.run_cell(SweepSpec(**base, trace=True))
    want = ref_runner.run_cell(R.SweepSpec(**base, trace=True))
    assert off.trace is None
    assert plain(off.metrics) == plain(on.metrics)
    assert plain(on.trace) == plain(want.trace)
    assert len(on.trace.decisions) > 0
