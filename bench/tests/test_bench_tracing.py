"""The reduction of a profiler trace (``harness/tracing.py``) on a made-up
trace: busy and idle time, the idle gaps by host span, kernels given to
their quantum, and quanta with missing kernel events left out."""

from __future__ import annotations

import pytest

from costs.kernels import call_cost, quantum_calls
from costs.peaks import least_seconds
from harness import tracing
from smallcfg import lm_dict

CPU, CUDA = False, True


def ev(name, a, b, dev=CPU):
    return (name, dev, a, b)


def _quantum(t, lm, e, b, drop=0):
    """Host span and kernels of one quantum of model 0 starting at ``t``."""
    n_flash = len([c for c in quantum_calls(lm, e, b, 16)
                   if c[0] == "flash_attention"])
    evs = [ev(f"quantum/0/{e}/{b}", t, t + 100)]
    k = t + 5
    for _ in range(n_flash - drop):
        evs.append(ev("flash_attention_kernel", k, k + 4, CUDA))
        k += 6
    evs += [ev("exit_head_tiles", k, k + 3, CUDA),
            ev("exit_head_fold", k + 3, k + 4, CUDA)]
    return evs, k + 4


def test_reduce():
    lm = lm_dict("phi4-mini-3.8b")
    evs = [ev("stretch_start", 0, 1), ev("stretch_end", 1000, 1001)]
    q1, end1 = _quantum(100, lm, 3, 2)
    q2, _ = _quantum(400, lm, 3, 2, drop=1)
    evs += q1 + q2 + [ev("decide", 300, 350),
                      ev("score_warp_kernel", 320, 330, CUDA)]
    out = tracing.reduce(evs, [lm], 16, [4])
    assert out["window_s"] == pytest.approx(1000e-6)
    kernel_us = sum(b - a for _, dev, a, b in evs if dev)
    assert out["busy_s"] == pytest.approx(kernel_us * 1e-6)
    gaps = dict(out["idle_gaps"])
    assert gaps["decide"] == pytest.approx(40e-6)   # 300-320, 330-350
    assert gaps["quantum"] > 0 and gaps["poll"] > 0
    assert sum(gaps.values()) == pytest.approx(1000e-6 - out["busy_s"])
    fa = out["kernels"]["flash_attention"]
    assert fa["quanta"] == 2 and fa["quanta_kept"] == 1  # q2 lost a kernel
    n = fa["calls"]
    assert fa["seconds"] == pytest.approx(n * 4e-6)
    least = sum(least_seconds(*call_cost(k, s, 4))
                for k, s in quantum_calls(lm, 3, 2, 16)
                if k == "flash_attention")
    assert fa["least_seconds"] == pytest.approx(least)
    assert out["kernels"]["exit_head"]["quanta_kept"] == 2
    assert out["quanta_seconds"] == pytest.approx(200e-6)
