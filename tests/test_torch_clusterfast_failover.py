"""The port's compiled cluster scan on the CPU: fail-over.

Fail-over runs as host barriers: the step freezes every lane at the next
``fail_at`` time, the host kills the device and re-dispatches its orphans
through a numpy mirror of the step's pick. One and two failures, under
every dispatcher, must leave completions and ``ServingMetrics`` equal with
``==`` to the reference scan's and the port ``ClusterSimulator``'s. The
ring's overflow retry, the G=1 collapse, the array rollup and the loud
rejections are in ``tests/test_torch_clusterfast_edges.py``.
"""

import pytest

from repro_torch.core import SUPPORTED_DISPATCHERS
from test_torch_clusterfast import run_three


def test_single_failure_bitwise():
    res = run_three("homogeneous", 2, 120.0, 1.0, seed=3,
                    fail_at=((0, 0.5),))
    assert [d.alive for d in res.metrics.per_device] == [False, True]


@pytest.mark.parametrize("dispatcher", SUPPORTED_DISPATCHERS)
def test_two_failures_every_dispatcher_bitwise(dispatcher):
    res = run_three("homogeneous", 3, 100.0, 0.9, seed=13,
                    dispatcher=dispatcher, power_d=3,
                    fail_at=((0, 0.3), (2, 0.6)))
    assert [d.alive for d in res.metrics.per_device] == [False, True, False]


def test_failure_in_heterogeneous_fleet():
    run_three("heterogeneous", 3, 100.0, 1.0, seed=17, dispatcher="jsq",
              fail_at=((1, 0.45),))
