"""The benchmark's operation counts from shapes against the port's cost
counter (``launch/graph_analysis.py::CostCounter``) on ``meta``, and the
kernel calls of a quantum against the launches it implies."""

from __future__ import annotations

import pytest
import torch

from costs.kernels import call_cost, quantum_calls
from costs.model import quantum_flops
from harness import deploy, launches
from repro_torch.launch.graph_analysis import count
from repro_torch.models import build_model
from smallcfg import lm_dict

ARCHS = ("phi4-mini-3.8b", "starcoder2-7b", "seamless-m4t-large-v2")


@pytest.mark.parametrize("exit_idx", (0, 3))
@pytest.mark.parametrize("arch", ARCHS)
def test_quantum_flops_match_the_cost_counter(arch, exit_idx):
    lm = lm_dict(arch)
    cfg = deploy.lm_config(lm)
    model = build_model(cfg, device="meta")
    b, s = 3, 12
    batch = {"tokens": torch.empty((b, s), dtype=torch.int64,
                                   device="meta")}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.empty((b, cfg.frontend_seq, cfg.d_model),
                                          device="meta")
    _, counter = count(model.exit_decision, batch, exit_idx)
    # the plain attention computes the whole square: counted as such here
    assert quantum_flops(lm, exit_idx, b, s, causal=1.0) == \
        pytest.approx(counter.flops, rel=1e-9)
    assert quantum_flops(lm, exit_idx, b, s) < counter.flops


@pytest.mark.parametrize("arch", ARCHS)
def test_quantum_calls_are_the_implied_launches(arch):
    lm = lm_dict(arch)
    for e in range(4):
        calls = quantum_calls(lm, e, 8, 128)
        want = launches.quantum_launches(lm, e)
        assert sum(c[0] == "flash_attention" for c in calls) == \
            want["flash_attention"]
        assert sum(c[0] == "exit_head" for c in calls) == want["exit_head"]


def test_call_costs():
    nbytes, ops, rate = call_cost("flash_attention",
                                  (8, 24, 8, 128, 128, 128, True), 2)
    assert ops == 4.0 * 8 * 24 * 128 * 128 * 128 / 2
    assert nbytes == (2 * 8 * 24 * 128 * 128 + 2 * 8 * 8 * 128 * 128) * 2
    assert rate == 989e12
    nbytes, ops, _ = call_cost("exit_head", (8, 3072, 200064), 2)
    assert ops == 2.0 * 8 * 3072 * 200064
    assert nbytes == (8 * 3072 + 3072 + 3072 * 200064) * 2 + 8 * 12
