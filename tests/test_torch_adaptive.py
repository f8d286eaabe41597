"""The port's online adaptation against the JAX reference's on the CPU.

Drift models, the online profiler and the safety controller are host numpy
and Python floats in both packages, folded in the same order, so every
multiplier, estimate and materialised table must be bitwise the reference's.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import adaptive as ref
from repro.core.profile import ProfileTable as RefTable
from repro_torch.core import adaptive as port
from repro_torch.core.profile import ProfileTable

DRIFT_KWARGS = {
    "thermal-throttle": [{}, dict(onset=0.5, ramp=1.0, peak=2.5)],
    "dvfs-step": [{}, dict(steps=((1.5, 0.8), (0.5, 1.7), (1.0, 1.2)))],
    "contention": [{}, dict(burst_rate=2.0, burst_duration=0.3,
                            magnitude=3.0, seed=4)],
}


def _drift_cases():
    assert sorted(DRIFT_KWARGS) == sorted(ref.DRIFTS)
    return [(name, i) for name in sorted(DRIFT_KWARGS)
            for i in range(len(DRIFT_KWARGS[name]))]


@pytest.mark.parametrize("name,case", _drift_cases())
def test_drift_multipliers_bitwise(name, case):
    kwargs = DRIFT_KWARGS[name][case]
    assert sorted(port.DRIFTS) == sorted(ref.DRIFTS)
    grid = np.linspace(0.0, 6.0, 241).tolist()
    shuffled = np.random.default_rng(case).permutation(grid).tolist()
    for seed in (0, 7 ^ 0xD21F):
        want_model = ref.make_drift(name, **kwargs)
        got_model = port.make_drift(name, **kwargs)
        for order in (grid, shuffled, grid):
            want_model.reset(seed)
            got_model.reset(seed)
            want = [want_model.multiplier(t) for t in order]
            got = [got_model.multiplier(t) for t in order]
            assert got == want
    assert got_model.name == want_model.name == name


def test_drift_factory_edges_match_the_reference():
    assert port.make_drift(None) is None and port.make_drift("none") is None
    with pytest.raises(ValueError) as want:
        ref.make_drift("no-such")
    with pytest.raises(ValueError) as got:
        port.make_drift("no-such")
    assert str(got.value) == str(want.value)
    assert port.make_profiler(ProfileTable.paper_rtx3080(), None) is None


def test_adapt_config_fields_and_hash_match_the_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(ref.AdaptConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(port.AdaptConfig)]
    assert got == want
    cfg = port.AdaptConfig(refresh_every=0.25)
    assert hash(cfg) == hash(port.AdaptConfig(refresh_every=0.25))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.alpha = 0.5


def _observations(seed, n=400):
    """(m, e, batch, service, now) from a drifting ground truth."""
    rng = np.random.default_rng(seed)
    table = ProfileTable.paper_rtx3080()
    out, now = [], 0.0
    for _ in range(n):
        m, e = int(rng.integers(0, 3)), int(rng.integers(0, 4))
        batch = int(rng.integers(1, 11))
        drift = 1.0 + 0.8 * min(now / 2.0, 1.0)
        service = table(m, e, batch) * drift * float(rng.lognormal(0, 0.05))
        now += service + float(rng.exponential(0.002))
        out.append((m, e, batch, service, now))
    return out


CONFIGS = [
    dict(),
    dict(mode="mean"),
    dict(propagate=False, window=8, min_samples=1),
    dict(safety=True, safety_target=0.02, refresh_every=0.1),
]


def _assert_tables_bitwise(got, want):
    assert got.latency.tobytes() == want.latency.tobytes()
    assert got.accuracy.tobytes() == want.accuracy.tobytes()
    assert got.meta == want.meta


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_online_profiler_folds_as_the_reference(cfg):
    kwargs = CONFIGS[cfg]
    want_p = ref.OnlineProfiler(RefTable.paper_rtx3080(),
                                ref.AdaptConfig(**kwargs))
    got_p = port.OnlineProfiler(ProfileTable.paper_rtx3080(),
                                port.AdaptConfig(**kwargs))
    rng = np.random.default_rng(cfg)
    refreshes = 0
    for m, e, batch, service, now in _observations(cfg):
        served = [type("Req", (), dict(arrival=now - service * k,
                                       deadline=None if k % 2 else 0.04))()
                  for k in range(1, batch + 1)]
        want = want_p.ingest_quantum(m, e, batch, service, now, served, 0.05)
        got = got_p.ingest_quantum(m, e, batch, service, now, served, 0.05)
        assert (got is None) == (want is None)
        if got is not None:
            refreshes += 1
            _assert_tables_bitwise(got, want)
        if rng.uniform() < 0.05:
            want_p.observe_dropped(2)
            got_p.observe_dropped(2)
        assert got_p.drift_ratio == want_p.drift_ratio
    assert refreshes > 3
    assert got_p.num_observations == want_p.num_observations
    _assert_tables_bitwise(got_p.materialize(), want_p.materialize())
    for cell in ((0, 3, 10), (2, 0, 1), (1, 2, 4)):
        assert got_p.cell_stats(*cell) == want_p.cell_stats(*cell)
    if kwargs.get("safety"):
        assert vars(got_p.safety) == vars(want_p.safety)
        assert got_p.safety.multiplier > 1.0


def test_safety_controller_state_bitwise():
    want, got = ref.SafetyController(target=0.05), port.SafetyController(
        target=0.05)
    rng = np.random.default_rng(11)
    for _ in range(500):
        if rng.uniform() < 0.03:
            want.observe_violation()
            got.observe_violation()
        else:
            lat = float(rng.uniform(0.0, 0.06))
            want.observe(lat, 0.05)
            got.observe(lat, 0.05)
        assert vars(got) == vars(want)
    assert want.num_observed == 500
