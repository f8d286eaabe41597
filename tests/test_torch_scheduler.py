"""The port's scheduling core against the JAX reference on the CPU.

Inputs are made from a seed with numpy and handed to both sides. Host
bookkeeping (profile tables, traces, numpy scores, metrics) must be bitwise
equal; the float32 backends are held to the reference's tolerances and to
equal decisions.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# importlib: ``repro.core`` re-exports functions named like its modules
ref_baselines, ref_metrics, ref_profile, ref_queues, ref_request, \
    ref_scheduler, ref_scoring, ref_traffic, ref_urgency = (
        importlib.import_module(f"repro.core.{name}") for name in (
            "baselines", "metrics", "profile", "queues", "request",
            "scheduler", "scoring", "traffic", "urgency"))

from repro_torch.core import baselines, metrics, profile, queues, request
from repro_torch.core import scheduler, scoring, traffic, urgency

POLICIES = sorted(ref_baselines.SCHEDULERS)


def _snapshot_arrays(seed, m_count=3, max_len=12, het_tau=False):
    rng = np.random.default_rng(seed)
    waits = [np.sort(rng.uniform(0, 0.08, size=rng.integers(0, max_len)))[::-1]
             for _ in range(m_count)]
    deadlines = None
    if het_tau:
        deadlines = [np.where(rng.uniform(size=len(w)) < 0.5,
                              rng.uniform(0.02, 0.09, size=len(w)), np.nan)
                     for w in waits]
    now = float(rng.uniform(0, 5))
    return now, waits, deadlines


def _both_snapshots(seed, **kw):
    now, waits, deadlines = _snapshot_arrays(seed, **kw)
    copy = (lambda xs: None if xs is None else [x.copy() for x in xs])
    return (ref_queues.QueueSnapshot(now, copy(waits), copy(deadlines)),
            queues.QueueSnapshot(now, copy(waits), copy(deadlines)))


def _fields(d):
    """Decision fields, with NaN (no score) made comparable."""
    if d is None:
        return None
    return tuple("nan" if isinstance(x, float) and np.isnan(x) else x
                 for x in dataclasses.astuple(d))


def _pick(d):
    return None if d is None else (d.model, d.exit_idx, d.batch_size,
                                   d.predicted_latency)


def _tables(name):
    return (getattr(ref_profile.ProfileTable, name)(),
            getattr(profile.ProfileTable, name)())


# ---------------------------------------------------------------------------
# Profile tables and traces: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["paper_rtx3080", "paper_gtx1650",
                                     "paper_jetson_orin_nano"])
def test_paper_tables_bitwise(builder):
    ref, port = _tables(builder)
    assert port.latency.tobytes() == ref.latency.tobytes()
    assert port.accuracy.tobytes() == ref.accuracy.tobytes()
    assert (port.model_names, port.exit_names, port.batch_sizes) == (
        ref.model_names, ref.exit_names, ref.batch_sizes)
    assert port.meta == ref.meta
    for m in range(ref.num_models):
        for e in range(ref.num_exits):
            for b in (1, 5, 10, 12):
                assert port(m, e, b) == ref(m, e, b)


@pytest.mark.parametrize("view", ["saturation", "restrict", "select",
                                  "safety"])
def test_table_views_bitwise(view):
    ref, port = _tables("paper_rtx3080")
    make = {
        "saturation": lambda t: t.with_batch_saturation(4, 0.7),
        "restrict": lambda t: t.restrict_exits([0, 3]),
        "select": lambda t: t.select_models([2, 0]),
        "safety": lambda t: t.with_safety(1.15),
    }[view]
    r, p = make(ref), make(port)
    assert p.latency.tobytes() == r.latency.tobytes()
    assert p.accuracy.tobytes() == r.accuracy.tobytes()
    assert p.meta == r.meta


def test_table_save_load_round_trip(tmp_path):
    ref, port = _tables("paper_rtx3080")
    ref.save(str(tmp_path / "ref.json"))
    port.save(str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_bytes() == (
        tmp_path / "port.json").read_bytes()
    back = profile.ProfileTable.load(str(tmp_path / "ref.json"))
    assert back.latency.tobytes() == ref.latency.tobytes()


@pytest.mark.parametrize("seed,lam,horizon,deadlines", [
    (0, 140.0, 3.0, None),
    (1, 60.0, 2.0, None),
    (7, 200.0, 0.5, (0.03, 0.05, 0.08)),
])
def test_poisson_traces_bitwise(seed, lam, horizon, deadlines):
    rates = traffic.paper_rate_vector(lam)
    assert rates == ref_traffic.paper_rate_vector(lam)
    ref = ref_traffic.poisson_arrivals(rates, horizon, seed=seed,
                                       deadlines=deadlines)
    port = traffic.poisson_arrivals(rates, horizon, seed=seed,
                                    deadlines=deadlines)
    assert [dataclasses.astuple(r) for r in port] == [
        dataclasses.astuple(r) for r in ref]


# ---------------------------------------------------------------------------
# Queues and urgency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("het", [False, True])
def test_padded_views_bitwise(het):
    for seed in range(10):
        ref, port = _both_snapshots(seed, het_tau=het)
        for a, b in zip(ref.padded(), port.padded()):
            assert a.tobytes() == b.tobytes() and a.shape == b.shape
        assert ref.padded_taus(0.05).tobytes() == port.padded_taus(
            0.05).tobytes()
        assert ref.padded(max_q=4)[0].tobytes() == port.padded(
            max_q=4)[0].tobytes()
        assert port.padded()[0].shape[1] >= 1   # cap >= 1 even when empty


def test_service_queue_matches_reference():
    rq, pq = ref_queues.ServiceQueue(0), queues.ServiceQueue(0)
    for i in range(7):
        dl = 0.03 if i % 3 == 0 else None
        rq.push(ref_request.Request(i, 0, 0.01 * i, deadline=dl))
        pq.push(request.Request(i, 0, 0.01 * i, deadline=dl))
    assert rq.waits(0.2).tobytes() == pq.waits(0.2).tobytes()
    assert np.array_equal(rq.deadlines(), pq.deadlines(), equal_nan=True)
    assert [r.req_id for r in rq.pop_batch(4)] == [
        r.req_id for r in pq.pop_batch(4)]
    assert rq.has_deadlines == pq.has_deadlines


def test_urgency_np_bitwise():
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 0.5, 1000)
    tau = rng.uniform(0.02, 0.09, 1000)
    for clip in (10.0, 3.0):
        assert urgency.urgency_np(w, 0.05, clip).tobytes() == (
            ref_urgency.urgency_np(w, 0.05, clip).tobytes())
        assert urgency.urgency_np(w, tau, clip).tobytes() == (
            ref_urgency.urgency_np(w, tau, clip).tobytes())
    waits = [w[:10], w[10:13], w[:0]]
    assert urgency.stability_score_np(waits, 0.05) == (
        ref_urgency.stability_score_np(waits, 0.05))


def test_torch_urgency_matches_jnp():
    rng = np.random.default_rng(4)
    w = rng.uniform(0, 0.4, (5, 17)).astype(np.float32)
    mask = (rng.uniform(size=(5, 17)) > 0.3).astype(np.float32)
    for clip in (10.0, 3.0):
        np.testing.assert_allclose(
            urgency.urgency(torch.from_numpy(w), 0.05, clip).numpy(),
            np.asarray(ref_urgency.urgency(jnp.asarray(w), 0.05, clip)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(urgency.stability_score(torch.from_numpy(w),
                                          torch.from_numpy(mask), 0.05, clip)),
            float(ref_urgency.stability_score(jnp.asarray(w),
                                              jnp.asarray(mask), 0.05, clip)),
            rtol=1e-5)


# ---------------------------------------------------------------------------
# Scoring backends
# ---------------------------------------------------------------------------


def _lattice_inputs(seed, het):
    ref_snap, _ = _both_snapshots(seed, het_tau=het, max_len=15)
    sched = ref_scheduler.LatticeEdgeServingScheduler(
        ref_profile.ProfileTable.paper_rtx3080(),
        ref_scheduler.SchedulerConfig(slo=0.05))
    cq, cb, _, cl, _ = sched.enumerate_candidates(ref_snap)
    w, mask = ref_snap.padded()
    tau = ref_snap.padded_taus(0.05) if ref_snap.has_deadlines else 0.05
    return w, mask, cl, cb, cq, tau


@pytest.mark.parametrize("het", [False, True])
@pytest.mark.parametrize("clip", [10.0, 3.0])
def test_numpy_scores_bitwise(het, clip):
    port = scoring.make_scoring_backend("numpy")
    ref = ref_scoring.make_scoring_backend("numpy")
    for seed in range(12):
        w, mask, cl, cb, cq, tau = _lattice_inputs(seed, het)
        if len(cq) == 0:
            continue
        a = ref.score(w, mask, cl, cb, cq, tau, clip)
        b = port.score(w, mask, cl, cb, cq, tau, clip)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("het", [False, True])
def test_float32_backends_match_jnp_and_float64(backend, het):
    port = scoring.make_scoring_backend(backend, "cpu")
    jnp_be = ref_scoring.make_scoring_backend("jnp")
    f64 = ref_scoring.make_scoring_backend("numpy")
    for seed in range(12):
        w, mask, cl, cb, cq, tau = _lattice_inputs(seed, het)
        if len(cq) == 0:
            continue
        got = port.score(w, mask, cl, cb, cq, tau, 10.0)
        assert got.dtype == np.float32 and got.shape == cq.shape
        np.testing.assert_allclose(
            got, jnp_be.score(w, mask, cl, cb, cq, tau, 10.0), rtol=1e-5)
        # the reference manifest's bound on the float32 tier (rtol 2e-4)
        np.testing.assert_allclose(
            got, f64.score(w, mask, cl, cb, cq, tau, 10.0), rtol=2e-4)


def test_backend_registry():
    assert sorted(scoring.SCORING_BACKENDS) == ["cuda", "numpy", "torch"]
    assert scoring.make_scoring_backend("numpy") is (
        scoring.make_scoring_backend("numpy"))
    assert scoring.make_scoring_backend("cuda", "cpu") is (
        scoring.make_scoring_backend("cuda", "cpu"))
    with pytest.raises(ValueError, match="unknown scoring backend"):
        scoring.make_scoring_backend("pallas")


def test_card_backends_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not reachable")
    for name in ("torch", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scoring.make_scoring_backend(name)


# ---------------------------------------------------------------------------
# Schedulers: equal decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("het", [False, True])
def test_policy_decisions_match_reference(policy, lattice, het):
    """Every policy, greedy and lattice, scalar and per-task tau: the numpy
    path gives the reference's Decision field for field (scores bitwise),
    and the same prune / wake-up answers."""
    ref_t, port_t = _tables("paper_rtx3080")
    ref_t, port_t = ref_t.with_batch_saturation(4), port_t.with_batch_saturation(4)
    cfg = dict(slo=0.04, max_batch=8, lattice=lattice)
    ref_s = ref_baselines.make_scheduler(
        policy, ref_t, ref_scheduler.SchedulerConfig(**cfg))
    port_s = baselines.make_scheduler(
        policy, port_t, scheduler.SchedulerConfig(**cfg))
    assert type(port_s).__name__ == type(ref_s).__name__
    for seed in range(20):
        ref_snap, port_snap = _both_snapshots(seed, het_tau=het)
        assert _fields(port_s.decide(port_snap)) == _fields(
            ref_s.decide(ref_snap))
        assert port_s.prune(port_snap) == ref_s.prune(ref_snap)
        if hasattr(ref_s, "next_wake"):
            assert port_s.next_wake(port_snap) == ref_s.next_wake(ref_snap)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("cls", ["EdgeServingScheduler",
                                 "VectorizedEdgeServingScheduler",
                                 "LatticeEdgeServingScheduler"])
@pytest.mark.parametrize("het", [False, True])
def test_float32_backend_decisions_match_reference(backend, cls, het):
    """The port's torch/cuda backends (plain version on the CPU) decide as
    the reference's jnp backend and the float64 loop do."""
    ref_t, port_t = _tables("paper_rtx3080")
    ref_s = getattr(ref_scheduler, cls)(
        ref_t, ref_scheduler.SchedulerConfig(slo=0.05, backend="jnp"))
    ref64 = getattr(ref_scheduler, cls)(
        ref_t, ref_scheduler.SchedulerConfig(slo=0.05))
    port_s = getattr(scheduler, cls)(port_t, scheduler.SchedulerConfig(
        slo=0.05, backend=backend, device="cpu"))
    assert port_s.scoring.name == backend
    for seed in range(15):
        ref_snap, port_snap = _both_snapshots(seed, het_tau=het)
        d_port = port_s.decide(port_snap)
        assert _pick(d_port) == _pick(ref_s.decide(ref_snap))
        d64 = ref64.decide(ref_snap)
        assert _pick(d_port) == _pick(d64)
        if d64 is not None:
            np.testing.assert_allclose(d_port.stability_score,
                                       d64.stability_score, rtol=2e-4)


def test_lattice_tiebreak_is_lexsort():
    """Equal scores resolve to the larger w_max, then candidate order —
    ``np.lexsort((-w_maxes, scores))`` as in the reference."""
    t = profile.ProfileTable.paper_rtx3080()
    s = scheduler.VectorizedEdgeServingScheduler(
        t, scheduler.SchedulerConfig(slo=0.05))
    snap = queues.QueueSnapshot(0.0, [np.array([0.01]), np.array([0.01])])
    s.score_candidates = lambda *a: np.zeros(2)
    d = s.decide_scored(snap)
    assert d.model == 0   # tie on score and w_max -> candidate order
    snap = queues.QueueSnapshot(0.0, [np.array([0.01]), np.array([0.02])])
    assert s.decide_scored(snap).model == 1   # tie on score -> larger w_max


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,dropped", [(0, 0), (20, 3), (500, 0)])
def test_summarize_equal(warmup, dropped):
    rng = np.random.default_rng(11)
    ref_t, port_t = _tables("paper_rtx3080")
    rows = []
    t = 0.0
    for i in range(200):
        t += float(rng.exponential(0.004))
        disp = t + float(rng.uniform(0, 0.05))
        rows.append(dict(req_id=i, model=int(rng.integers(0, 3)), arrival=t,
                         dispatch=disp, finish=disp + float(rng.uniform(
                             0.001, 0.02)),
                         exit_idx=int(rng.integers(0, 4)),
                         batch_size=int(rng.integers(1, 11)),
                         deadline=(0.03 if i % 7 == 0 else None)))
    kw = dict(slo=0.05, warmup_tasks=warmup, busy_time=0.6, span=1.1,
              residual_queue=4, dropped=dropped)
    ref = ref_metrics.summarize(
        [ref_request.Completion(**r) for r in rows], ref_t, **kw)
    port = metrics.summarize(
        [request.Completion(**r) for r in rows], port_t, **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
