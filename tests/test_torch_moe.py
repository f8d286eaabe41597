"""The port's Mixture-of-Experts against the JAX reference on the CPU: the
layer alone (both routers, shared experts, capacity drops, a token count
that is not a multiple of the group, the aux loss, ties in the router's
scores) and the DeepSeek-MoE-16B SMOKE model through every entry point.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.moe import MoEConfig as RefMoEConfig
from repro.models.moe import moe as ref_moe

from repro_torch.models.moe import (
    MoEConfig,
    init_moe,
    moe,
    record_routing,
    stable_top_k,
)

from torch_zoo import TOL, FamilyChecks

torch.set_num_threads(1)


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    shapes = {"router": (d, e), "we_gate": (e, d, f), "we_up": (e, d, f),
              "we_down": (e, f, d)}
    p = {k: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in shapes.items()}
    if cfg.num_shared:
        fs = cfg.shared_ff
        p["shared"] = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(
            np.float32) for k, s in (("w_gate", (d, fs)), ("w_up", (d, fs)),
                                     ("w_down", (fs, d)))}
    return p


def _both(p, x, **kw):
    ref_cfg, cfg = RefMoEConfig(**kw), MoEConfig(**kw)

    def tree(conv):
        return {k: ({kk: conv(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else conv(v))
                for k, v in p.items()}

    want, want_aux = ref_moe(tree(jnp.asarray), jnp.asarray(x), ref_cfg)
    with record_routing() as log:
        got, got_aux = moe(tree(torch.from_numpy), torch.from_numpy(x), cfg)
    return (got, got_aux, log), (np.asarray(want), float(want_aux))


CASES = {
    "softmax_shared": dict(num_experts=8, top_k=2, num_shared=2,
                           router_type="softmax", group_size=16),
    "sigmoid_shared": dict(num_experts=8, top_k=3, num_shared=1,
                           router_type="sigmoid", group_size=16),
    "no_shared": dict(num_experts=4, top_k=2, num_shared=0, group_size=8),
    "drops": dict(num_experts=8, top_k=2, num_shared=1, group_size=16,
                  capacity_factor=0.25),
    "ragged_groups": dict(num_experts=8, top_k=2, num_shared=2,
                          group_size=7),
    "one_group": dict(num_experts=6, top_k=6, num_shared=0,
                      group_size=1024, router_type="sigmoid"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_layer_matches_reference(case):
    kw = dict(d_model=24, d_ff_expert=16, **CASES[case])
    p = _params(MoEConfig(**kw), seed=len(case))
    x = np.random.default_rng(len(case)).normal(size=(3, 11, 24)).astype(
        np.float32)
    (got, aux, log), (want, want_aux) = _both(p, x, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5, atol=1e-7)
    (call,) = log
    assert call["idx"].shape == (33, kw["top_k"])
    if case == "drops":  # capacity 1 per expert and group of 16: drops
        assert not bool(call["kept"].all())


def test_stable_top_k_breaks_ties_by_index_like_lax_top_k():
    scores = torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.125],
                           [0.25, 0.25, 0.25, 0.25, 0.25]])
    values, idx, nxt = stable_top_k(scores, 2)
    assert idx.tolist() == [[1, 3], [0, 1]]
    assert values.tolist() == [[0.75, 0.75], [0.25, 0.25]]
    assert nxt.tolist() == [0.5, 0.25]
    _, _, none = stable_top_k(scores, 5)
    assert bool(torch.isinf(none).all())


def test_tied_router_scores_route_like_the_reference():
    """A router whose experts come in pairs of identical columns gives
    exactly equal scores in pairs, so the third choice of a top-3 ties with
    the fourth for every token; the lower index wins on both sides, so the
    outputs (whose experts differ) agree."""
    kw = dict(d_model=16, d_ff_expert=8, num_experts=6, top_k=3,
              num_shared=0, group_size=32)
    p = _params(MoEConfig(**kw), seed=3)
    for a, b in ((1, 4), (0, 2), (3, 5)):
        p["router"][:, b] = p["router"][:, a]
    x = np.random.default_rng(4).normal(size=(1, 20, 16)).astype(np.float32)
    (got, _, log), (want, _) = _both(p, x, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert bool((log[0]["kth"] == log[0]["next"]).all())
    assert set(log[0]["idx"][:, 2].tolist()) <= {1, 0, 3}  # lower of a pair


def test_init_moe_draws_the_reference_tree_one_expert_at_a_time():
    cfg = MoEConfig(d_model=32, d_ff_expert=8, num_experts=5, top_k=2,
                    num_shared=2)
    gen = torch.Generator().manual_seed(0)
    p = init_moe(gen, cfg, dtype=torch.bfloat16)
    assert set(p) == {"router", "we_gate", "we_up", "we_down", "shared"}
    assert p["we_gate"].shape == (5, 32, 8) and p["we_down"].shape == (5, 8,
                                                                       32)
    assert p["shared"]["w_up"].shape == (32, 16)
    assert p["we_up"].dtype == torch.bfloat16
    # the reference's fan-in rule on the stacked shape: 1/sqrt(E)
    bound = 2 / np.sqrt(5)
    assert float(p["we_up"].float().abs().max()) <= bound * 1.01
    assert not torch.equal(p["we_up"][0], p["we_up"][1])
    assert float(p["router"].float().abs().max()) <= 0.04 * 1.01


class TestDeepSeekMoE(FamilyChecks):
    ARCH = "deepseek-moe-16b"
