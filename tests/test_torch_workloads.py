"""The port's workload scenarios against the JAX reference's on the CPU.

Both packages draw every trace from numpy's ``Generator`` in the same order,
so a trace for a given seed must be bitwise the reference's: the tuples are
compared with ``==``, not a tolerance. The columnar form the compiled scans
read (``TraceColumns``) is held the same way.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import workloads as ref
from repro_torch.core import workloads as port
from repro_torch.core.traffic import paper_rate_vector

RATES = paper_rate_vector(140.0)
DEADLINES = (0.030, 0.050, 0.080)
HORIZON = 2.0
SEEDS = (0, 7)


def _rows(requests):
    return [(r.req_id, r.model, r.arrival, r.data_id, r.deadline)
            for r in requests]


def _both(name, deadlines=None, **kwargs):
    return (ref.make_scenario(name, RATES, deadlines=deadlines, **kwargs),
            port.make_scenario(name, RATES, deadlines=deadlines, **kwargs))


@pytest.mark.parametrize("deadlines", [None, DEADLINES],
                         ids=["scalar_slo", "per_model_slo"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_scenario_traces_bitwise(name, seed, deadlines):
    assert sorted(port.SCENARIOS) == sorted(ref.SCENARIOS)
    want, got = (_rows(p.generate(HORIZON, seed=seed))
                 for p in _both(name, deadlines))
    assert len(want) > 100
    assert got == want


@pytest.mark.parametrize("name,kwargs", [
    ("mmpp", dict(burst=4.0, duty=0.2, cycle=0.5)),
    ("diurnal", dict(period=1.0, depth=0.5, phase=0.3)),
    ("flash-crowd", dict(spike_start=0.5, spike_duration=0.4,
                         magnitude=8.0, spike_models=(0,))),
    ("trace-replay", dict(burst=2.0, duty=0.4)),
])
def test_scenario_parameters_bitwise(name, kwargs):
    want, got = (_rows(p.generate(HORIZON, seed=3, data_pool=50))
                 for p in _both(name, **kwargs))
    assert got == want
    ref_p, port_p = _both(name, **kwargs)
    assert ([port_p.mean_rate(m) for m in range(3)]
            == [ref_p.mean_rate(m) for m in range(3)])


@pytest.mark.parametrize("time_scale", [1.0, 0.5])
def test_record_trace_round_trip(time_scale):
    """An explicit recorded trace replays (scaled, cut at the horizon,
    re-numbered) as the reference replays it."""
    source = port.MMPPProcess(RATES).generate(HORIZON, seed=1)
    recorded = port.record_trace(source)
    assert recorded == ref.record_trace(
        ref.MMPPProcess(RATES).generate(HORIZON, seed=1))
    assert _rows(port.TraceReplayProcess(recorded).generate(HORIZON)) == \
        _rows(source)
    want = ref.TraceReplayProcess(recorded, time_scale=time_scale,
                                  deadlines=DEADLINES).generate(HORIZON)
    got = port.TraceReplayProcess(recorded, time_scale=time_scale,
                                  deadlines=DEADLINES).generate(HORIZON)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_burstiness_diagnostics_equal(name):
    ref_p, port_p = _both(name)
    want, got = ref_p.generate(HORIZON, seed=7), port_p.generate(HORIZON, seed=7)
    for model in (None, 0, 1, 2):
        assert (port.interarrival_cov(got, model)
                == ref.interarrival_cov(want, model))
        assert (port.burstiness_index(got, model)
                == ref.burstiness_index(want, model))
    assert port.interarrival_cov(got[:2]) == 0.0


def test_unknown_scenario_message_is_the_reference_one():
    with pytest.raises(ValueError) as want:
        ref.make_scenario("no-such", RATES)
    with pytest.raises(ValueError) as got:
        port.make_scenario("no-such", RATES)
    assert str(got.value) == str(want.value)


def test_zero_rate_models_get_no_traffic():
    rates = (0.0, 50.0, 0.0)
    for name in sorted(ref.SCENARIOS):
        got = port.make_scenario(name, rates).generate(HORIZON, seed=2)
        want = ref.make_scenario(name, rates).generate(HORIZON, seed=2)
        assert _rows(got) == _rows(want)
        assert {r.model for r in got} == {1}
        assert np.all(np.diff([r.arrival for r in got]) >= 0)


def _columns_equal(got, want):
    assert np.array_equal(got.arrival, want.arrival)
    assert np.array_equal(got.model, want.model)
    assert np.array_equal(got.data_id, want.data_id)
    if want.deadline is None:
        assert got.deadline is None
    else:
        assert np.array_equal(got.deadline, want.deadline, equal_nan=True)
    assert got.arrival.dtype == want.arrival.dtype == np.float64
    assert got.model.dtype == want.model.dtype


@pytest.mark.parametrize("deadlines", [None, DEADLINES],
                         ids=["scalar_slo", "per_model_slo"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_trace_columns_equal_the_reference(name, seed, deadlines):
    """Every scenario's ``generate_columns`` is the reference's, and the
    columns of its ``generate()`` lane (trace replay falls back through
    ``generate``)."""
    ref_p, port_p = _both(name, deadlines)
    got = port_p.generate_columns(HORIZON, seed=seed)
    _columns_equal(got, ref_p.generate_columns(HORIZON, seed=seed))
    _columns_equal(got, port.columns_from_requests(
        port_p.generate(HORIZON, seed=seed)))
    assert len(got) > 100


def test_trace_columns_index_as_requests():
    proc = port.make_scenario("mmpp", RATES, deadlines=DEADLINES)
    reqs = proc.generate(HORIZON, seed=1)
    cols = proc.generate_columns(HORIZON, seed=1)
    assert len(cols) == len(reqs)
    assert list(cols) == reqs
    assert cols[len(reqs) // 2] == reqs[len(reqs) // 2]
    mixed = [reqs[0], dataclasses.replace(reqs[1], deadline=None)]
    want = ref.columns_from_requests(
        [ref.Request(**dataclasses.asdict(r)) for r in mixed])
    _columns_equal(port.columns_from_requests(mixed), want)
    assert port.columns_from_requests(mixed)[1].deadline is None
