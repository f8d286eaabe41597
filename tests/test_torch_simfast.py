"""The port's compiled single-device scan against the reference's and the
port's Python engine, on the CPU.

``repro_torch.core.simfast`` runs the serving loop as one float64 step over
many lanes. On the same inputs it must make the reference scan's and the
port ``ServingSimulator``'s decisions at the same clocks, so their
``ServingMetrics`` are equal with ``==``. Scores and margins are summed in
another order than the reference's and may differ by an ulp; they are held
at rtol 1e-9 with an atol of 1e-12 (a score of 0.0 against 2.2e-16 is the
same decision).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
from jax.experimental import enable_x64

import repro.core as R
import repro_torch.core as P
from repro.core import simfast as ref_simfast
from repro_torch.core import (
    ProfileTable,
    Request,
    ScanEngineUnsupported,
    SchedulerConfig,
    ServingSimulator,
    SweepRunner,
    SweepSpec,
    Tracer,
    export_ndjson,
    make_scheduler,
    paper_rate_vector,
    poisson_arrivals,
    simulate_scan,
    simulate_scan_batch,
)
from repro_torch.core import simfast

SUPPORTED = ("edgeserving", "edgeserving-vec", "edgeserving-lattice",
             "allfinal-deadline-aware", "ours-bs1")
UNSUPPORTED = ("all-final", "all-early", "symphony", "earlyexit-lqf",
               "earlyexit-edf")
LAMBDAS = (60.0, 140.0, 220.0)
HORIZON = 1.0
GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_metrics.json"
SCORE_RTOL, SCORE_ATOL = 1e-9, 1e-12


def _tables():
    return (ProfileTable.paper_rtx3080().with_batch_saturation(4),
            R.ProfileTable.paper_rtx3080().with_batch_saturation(4))


def _sched(policy, table, pkg, slo=0.05):
    """The policy's scheduler in the port (``pkg=P``) or the reference
    (``pkg=R``); ``edgeserving-vec`` has no registry name."""
    cfg = pkg.SchedulerConfig(slo=slo)
    if policy == "edgeserving-vec":
        return pkg.VectorizedEdgeServingScheduler(table, cfg)
    return pkg.make_scheduler(policy, table, cfg)


def _both_lanes(lams, horizon, seed, deadlines=None):
    port = [poisson_arrivals(paper_rate_vector(lam), horizon, seed=seed)
            for lam in lams]
    ref = [R.poisson_arrivals(R.paper_rate_vector(lam), horizon, seed=seed)
           for lam in lams]
    if deadlines is not None:
        port = [[dataclasses.replace(r, deadline=deadlines[r.model])
                 for r in lane] for lane in port]
        ref = [[dataclasses.replace(r, deadline=deadlines[r.model])
                for r in lane] for lane in ref]
    return port, ref


def _decisions(res):
    """(dispatch clock, finish clock, model, exit, batch) per round."""
    return [(t.t_start, t.t_end, t.decision.model, t.decision.exit_idx,
             t.decision.batch_size) for t in res.traces]


def _scores(res):
    return np.array([t.decision.stability_score for t in res.traces])


def _check_three(port, ref, py):
    """Port scan == reference scan == port Python engine."""
    assert dataclasses.asdict(port.metrics) == dataclasses.asdict(ref.metrics)
    assert port.metrics == py.metrics
    assert _decisions(port) == _decisions(ref) == _decisions(py)
    np.testing.assert_allclose(_scores(port), _scores(ref),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert [c.req_id for c in port.completions] == \
        [c.req_id for c in py.completions]


def _run_three(policy, lanes, ref_lanes, horizon, num_models=3,
               model_map=None, tables=None, **scan_kw):
    table, ref_table = tables or _tables()
    port = simulate_scan_batch(
        _sched(policy, table, P), table, lanes, horizon,
        num_models=num_models, model_map=model_map, keep_traces=True,
        keep_completions=True, device="cpu", **scan_kw)
    ref = ref_simfast.simulate_scan_batch(
        _sched(policy, ref_table, R), ref_table, ref_lanes, horizon,
        num_models=num_models, model_map=model_map, keep_traces=True,
        keep_completions=True, **scan_kw)
    py = [ServingSimulator(_sched(policy, table, P), table,
                           num_models=num_models, model_map=model_map).run(
        lane, horizon, keep_traces=True) for lane in lanes]
    for p, r, s in zip(port, ref, py):
        _check_three(p, r, s)
    return port


@pytest.mark.parametrize("policy", SUPPORTED)
def test_policy_grid_bitwise(policy):
    """Every supported policy, lambda in {60, 140, 220} as three lanes of
    one batch: metrics, decisions and clocks equal to the reference scan's
    and the port Python engine's."""
    lanes, ref_lanes = _both_lanes(LAMBDAS, HORIZON, seed=7)
    port = _run_three(policy, lanes, ref_lanes, HORIZON)
    assert all(r.metrics.num_completed > 0 for r in port)


def test_batch_lanes_equal_single_runs():
    lanes, _ = _both_lanes((100.0, 180.0), 1.0, seed=3)
    table, _ = _tables()
    sched = _sched("edgeserving", table, P)
    batch = simulate_scan_batch(sched, table, lanes, 1.0, device="cpu",
                                keep_completions=True)
    for lane, got in zip(lanes, batch):
        one = simulate_scan(sched, table, lane, 1.0, device="cpu",
                            keep_completions=True)
        assert got.metrics == one.metrics
        assert got.completions == one.completions


def test_model_map_deployment_mix():
    port = [poisson_arrivals([100.0, 100.0, 100.0], 1.5, seed=4)]
    ref = [R.poisson_arrivals([100.0, 100.0, 100.0], 1.5, seed=4)]
    _run_three("edgeserving", port, ref, 1.5, model_map=[0, 0, 0])


def test_per_model_constant_deadlines():
    lanes, ref_lanes = _both_lanes((120.0,), 1.5, seed=9,
                                   deadlines=(0.060, 0.045, 0.035))
    _run_three("edgeserving", lanes, ref_lanes, 1.5)


def test_overflow_retry_widens_the_window():
    """max_queue=2 is far below the true depth at lambda=140: the engine
    retries with the window doubled, records each retry on the tracer, and
    the result equals an unforced run's and the reference's."""
    lanes, ref_lanes = _both_lanes((140.0,), 0.6, seed=5)
    _run_three("edgeserving", lanes, ref_lanes, 0.6, max_queue=2)
    table, ref_table = _tables()
    tracer, ref_tracer = Tracer(), R.Tracer()
    got = simulate_scan(_sched("edgeserving", table, P), table, lanes[0],
                        0.6, max_queue=2, tracer=tracer, device="cpu")
    want = ref_simfast.simulate_scan(_sched("edgeserving", ref_table, R),
                                     ref_table, ref_lanes[0], 0.6,
                                     max_queue=2, tracer=ref_tracer)
    events = [(e.t, e.kind, e.payload) for e in got.trace.events]
    assert events == [(e.t, e.kind, e.payload) for e in want.trace.events]
    assert [e[1] for e in events] == ["overflow-retry"] * len(events)
    assert len(events) >= 2


def test_empty_arrivals():
    port = _run_three("edgeserving", [[]], [[]], 1.0)
    assert port[0].metrics.num_completed == 0


@pytest.mark.parametrize("factored", [True, False])
def test_factored_and_direct_scoring(factored):
    """Both scoring modes make the Python engine's decisions (the direct
    mode runs the float64 ``lattice_stability_scores``)."""
    lanes, ref_lanes = _both_lanes((140.0,), 1.5, seed=7)
    _run_three("edgeserving-lattice", lanes, ref_lanes, 1.5,
               factored=factored)


def test_exact_tie_takes_the_first_candidate():
    """Two queues with the same state and the same latencies (one model's
    profile row for all three) score the same to the bit: the reference's
    tiebreak (score, then w_max, then candidate order) serves queue 0
    first, in every engine."""
    tables = (ProfileTable.paper_rtx3080().select_models([0, 0, 0]),
              R.ProfileTable.paper_rtx3080().select_models([0, 0, 0]))
    port = [Request(req_id=0, model=1, arrival=0.01),
            Request(req_id=1, model=0, arrival=0.01),
            Request(req_id=2, model=2, arrival=0.5)]
    ref = [R.Request(req_id=r.req_id, model=r.model, arrival=r.arrival)
           for r in port]
    res = _run_three("edgeserving", [port], [ref], 1.0, tables=tables)[0]
    assert [t.decision.model for t in res.traces] == [0, 1, 2]
    assert res.traces[0].t_start == np.nextafter(0.01, np.inf)


def test_graph_block_length_does_not_change_results(monkeypatch):
    """The step count per graph block is a throughput knob: one step per
    block gives the default's result bitwise."""
    lanes, _ = _both_lanes((140.0, 220.0), 1.0, seed=2)
    table, _ = _tables()
    sched = _sched("edgeserving", table, P)
    want = simulate_scan_batch(sched, table, lanes, 1.0, device="cpu",
                               keep_traces=True)
    simfast._scan_steps.cache_clear()
    monkeypatch.setattr(simfast, "GRAPH_STEPS", 1)
    got = simulate_scan_batch(sched, table, lanes, 1.0, device="cpu",
                              keep_traces=True)
    simfast._scan_steps.cache_clear()
    for a, b in zip(got, want):
        assert a.metrics == b.metrics
        assert _decisions(a) == _decisions(b)
        assert np.array_equal(_scores(a), _scores(b))


def _chunk_inputs(rng, M, pad, n):
    arr = np.full((2, M, pad, 2), np.inf)
    arr[:, :, :, 1] = 0.0
    tau = np.array([0.05, 0.04, 0.06])
    for li in range(2):
        for m in range(M):
            a = np.sort(rng.uniform(0.0, 0.2, n))
            arr[li, m, :n, 0] = a
            arr[li, m, :n, 1] = np.exp(-a / tau[m])
    return arr, tau


@pytest.mark.parametrize("factored", [True, False])
def test_one_chunk_equals_the_reference_chunk(factored):
    """One chunk of the port's step against the reference's compiled chunk
    on a crafted carry: a served count past ``P - (Q + 1)`` makes
    ``lax.dynamic_slice`` clamp its window start, and the port's gather
    clamps the same way. Codes, clocks and the carry are bitwise equal."""
    table, ref_table = _tables()
    sched = _sched("edgeserving-lattice", table, P)
    M, E, Q, pad, Bmax, n = 3, table.num_exits, 4, 12, 10, 9
    ladder = simfast._build_ladder(sched, Bmax)
    kw = dict(num_models=M, num_exits=E, max_queue=Q, pad_len=pad,
              chunk_steps=8, max_batch=Bmax, ladder=ladder,
              allowed=(True,) * E, fallback_exit=0, clip=10.0,
              factored=factored, emit_aux=True)
    arr, tau = _chunk_inputs(np.random.default_rng(0), M, pad, n)
    sched_lat = simfast._dense_latency(table, [0, 1, 2], E, Bmax)
    lat_by_cap = np.ascontiguousarray(
        sched_lat[:, :, np.array(ladder)].transpose(0, 2, 1, 3))
    t0 = np.array([0.05, 0.12])
    served = np.array([[8, 0, 3], [2, 9, 5]])     # 8, 9 > P - (Q + 1) = 7

    with enable_x64():
        import jax.numpy as jnp
        fn = ref_simfast._build_chunk_fn(ref_simfast._StaticKey(**kw))
        carry = (jnp.asarray(t0), jnp.asarray(served, dtype=jnp.int32),
                 jnp.zeros(2), jnp.zeros(2, bool), jnp.zeros(2, bool))
        want_carry, want_ys = fn(carry, jnp.asarray(arr),
                                 jnp.asarray(lat_by_cap),
                                 jnp.asarray(sched_lat), jnp.asarray(tau),
                                 jnp.asarray(600.0))
        want_carry = [np.asarray(c) for c in want_carry]
        want_ys = [np.asarray(y) for y in want_ys]

    steps = simfast._ScanSteps(simfast._StaticKey(**kw), 2,
                               simfast.resolve_device("cpu"))
    steps.load(arr[..., 0], arr[..., 1], lat_by_cap, sched_lat, tau, 600.0)
    steps.t.copy_(simfast.torch.from_numpy(t0))
    steps.served.copy_(simfast.torch.from_numpy(served))
    code, t_out, score, margin = (y.T.numpy() for y in steps.eager())
    assert np.array_equal(code, want_ys[0])
    assert np.array_equal(t_out, want_ys[1])
    np.testing.assert_allclose(score, want_ys[2], rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(margin, want_ys[3], rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    for got, want in zip(steps.carry, want_carry):
        assert np.array_equal(got.numpy(), want), (got, want)
    assert (code >= 0).any()


def _records(path):
    return [json.loads(line) for line in pathlib.Path(path).read_text()
            .splitlines()]


def test_tracer_export_equals_the_reference(tmp_path):
    """The traced scan's NDJSON export is the reference scan's, byte for
    byte, apart from each decision's score and margin (held at rtol 1e-9,
    atol 1e-12)."""
    lanes, ref_lanes = _both_lanes((140.0,), 1.5, seed=11)
    table, ref_table = _tables()
    tracer, ref_tracer = Tracer(), R.Tracer()
    got = simulate_scan(_sched("edgeserving", table, P), table, lanes[0],
                        1.5, tracer=tracer, device="cpu")
    want = ref_simfast.simulate_scan(_sched("edgeserving", ref_table, R),
                                     ref_table, ref_lanes[0], 1.5,
                                     tracer=ref_tracer)
    a = _records(export_ndjson(got.trace, str(tmp_path / "port.ndjson")))
    b = _records(R.export_ndjson(want.trace, str(tmp_path / "ref.ndjson")))
    assert len(a) == len(b) and len(a) > 100
    for ra, rb in zip(a, b):
        if ra["type"] == "decision":
            for f in ("score", "margin"):
                va, vb = ra.pop(f), rb.pop(f)
                if isinstance(va, str) or isinstance(vb, str):
                    assert va == vb, f
                else:
                    np.testing.assert_allclose(va, vb, rtol=SCORE_RTOL,
                                               atol=SCORE_ATOL, err_msg=f)
        assert ra == rb
    # and the timeline is the Python engine's
    py_tracer = Tracer()
    py = ServingSimulator(_sched("edgeserving", table, P), table,
                          num_models=3, tracer=py_tracer).run(lanes[0], 1.5)
    assert [dataclasses.replace(d, score=0.0, margin=0.0)
            for d in got.trace.decisions] == \
        [dataclasses.replace(d, score=0.0, margin=0.0)
         for d in py.trace.decisions]
    assert got.trace.spans == py.trace.spans


def test_fig4_lam140_golden_through_the_scan_sweep_cell():
    """The fig4 lambda=140 golden row, ``per_model`` included, through
    ``SweepSpec(engine="scan")`` at the goldens' rtol=1e-9."""
    runner = SweepRunner(ProfileTable.paper_rtx3080())
    res = runner.run_cell(SweepSpec(policy="edgeserving", rate=140.0, seed=7,
                                    horizon=10.0, engine="scan",
                                    device="cpu"))
    got = dataclasses.asdict(res.metrics)
    want = json.loads(GOLDEN.read_text())["fig4_lam140"]
    assert got.keys() == want.keys()
    for key in want:
        if key in ("per_model", "per_device"):
            assert len(got[key]) == len(want[key]), key
            for gm, wm in zip(got[key], want[key]):
                for f in wm:
                    np.testing.assert_allclose(
                        gm[f], wm[f], rtol=1e-9, err_msg=f"{key}.{f}")
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       err_msg=key)


# -- loud rejection: the reference's cases, raised by the port too ----------


def _arrivals_pair():
    return (poisson_arrivals(paper_rate_vector(50.0), 1.0, seed=1),
            R.poisson_arrivals(R.paper_rate_vector(50.0), 1.0, seed=1))


@pytest.mark.parametrize("policy", UNSUPPORTED)
def test_unsupported_policies_raise(policy):
    table, ref_table = _tables()
    port, ref = _arrivals_pair()
    with pytest.raises(R.ScanEngineUnsupported):
        R.simulate_scan(_sched(policy, ref_table, R), ref_table, ref, 1.0,
                        num_models=3)
    with pytest.raises(ScanEngineUnsupported):
        simulate_scan(_sched(policy, table, P), table, port, 1.0,
                      num_models=3, device="cpu")


def test_non_numpy_backend_raises():
    """The reference rejects its ``jnp`` backend; the port its ``torch``
    and ``cuda`` backends (the same knob)."""
    table, ref_table = _tables()
    port, ref = _arrivals_pair()
    with pytest.raises(R.ScanEngineUnsupported):
        R.simulate_scan(R.make_scheduler("edgeserving", ref_table,
                                         R.SchedulerConfig(backend="jnp")),
                        ref_table, ref, 1.0, num_models=3)
    for backend in ("torch", "cuda"):
        sched = make_scheduler("edgeserving", table,
                               SchedulerConfig(backend=backend, device="cpu"))
        with pytest.raises(ScanEngineUnsupported):
            simulate_scan(sched, table, port, 1.0, num_models=3,
                          device="cpu")


def test_varying_deadlines_raise():
    table, ref_table = _tables()
    port, ref = _arrivals_pair()
    rng = np.random.default_rng(0)
    dl = rng.uniform(0.02, 0.09, len(port))
    port = [dataclasses.replace(r, deadline=float(d)) for r, d in zip(port, dl)]
    ref = [dataclasses.replace(r, deadline=float(d)) for r, d in zip(ref, dl)]
    with pytest.raises(R.ScanEngineUnsupported):
        R.simulate_scan(_sched("edgeserving", ref_table, R), ref_table, ref,
                        1.0, num_models=3)
    with pytest.raises(ScanEngineUnsupported):
        simulate_scan(_sched("edgeserving", table, P), table, port, 1.0,
                      num_models=3, device="cpu")


def test_unsorted_arrivals_raise():
    table, _ = _tables()
    port, _ = _arrivals_pair()
    with pytest.raises(ValueError, match="sorted"):
        simulate_scan(_sched("edgeserving", table, P), table,
                      list(reversed(port)), 1.0, num_models=3, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(drift="thermal-throttle"),
    dict(scenario="trace-replay"),
    dict(backend="torch"),
    dict(fleet="homogeneous", fleet_size=2, trace=True),
    dict(fleet="homogeneous", fleet_size=3, dispatcher="stability-aware"),
])
def test_sweep_cell_rejects(kw):
    table, ref_table = _tables()
    ref_kw = dict(kw, backend="jnp") if "backend" in kw else kw
    with pytest.raises(R.ScanEngineUnsupported):
        R.SweepRunner(ref_table).run_cell(R.SweepSpec(
            policy="edgeserving", rate=40.0, horizon=1.0, engine="scan",
            **ref_kw))
    with pytest.raises(ScanEngineUnsupported):
        SweepRunner(table).run_cell(SweepSpec(
            policy="edgeserving", rate=40.0, horizon=1.0, engine="scan",
            device="cpu", **kw))


def test_sweep_noise_and_unknown_engine_rejected():
    table, _ = _tables()
    spec = SweepSpec(policy="edgeserving", rate=40.0, horizon=1.0,
                     engine="scan", device="cpu")
    with pytest.raises(ScanEngineUnsupported):
        SweepRunner(table, service_noise_cov=0.03).run_cell(spec)
    with pytest.raises(ValueError):
        SweepRunner(table).run_cell(dataclasses.replace(spec,
                                                        engine="fortran"))
    with pytest.raises(ValueError, match="run_cell"):
        SweepRunner(table).simulator(spec)


def test_no_card_no_fallback(monkeypatch):
    """``device=None`` means the card: without one the scan raises instead
    of running on the host."""
    monkeypatch.setattr(simfast.torch.cuda, "is_available", lambda: False)
    table, _ = _tables()
    port, _ = _arrivals_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_scan(_sched("edgeserving", table, P), table, port, 1.0)
