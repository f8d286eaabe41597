"""The port's optimizers, clipping and schedule against the reference's on
the CPU: SGD, AdamW and Adafactor over a mixed tree (a 1-D leaf, a
[160, 130] matrix Adafactor factors, a 3-D leaf factored over its two
largest dims, a small matrix it does not factor, a bfloat16 leaf), three
steps each from the same values, gradients and state; ``global_norm``,
``clip_by_global_norm`` and ``cosine_schedule`` at every step 0..total.

Tolerances: rtol 1e-6 where the arithmetic is elementwise (the host's
float32 scalars and XLA's may differ in the last bit of a pow or cos, and
XLA may fuse a multiply-add), with an atol of rtol times the leaf's largest
value for elements where two terms cancel (SGD's ``0.9 m + g``); 1e-5 for
Adafactor, whose row and column means sum in another order; the bfloat16
leaf within one bfloat16 step (2^-7) at the leaf's scale (XLA rounds a
fused bfloat16 expression once, torch after each op).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import optimizers as R

from repro_torch.optim import (
    SGD,
    AdamW,
    Adafactor,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)

SHAPES = {"bias": (5,), "w": (160, 130), "t3": (3, 130, 140),
          "small": (6, 7), "half": (4, 8)}
BF16 = {"half"}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _ref(tree_np):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in tree_np.items()}


def _port(tree_np):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16
                                      else torch.float32)
            for k, v in tree_np.items()}


def _assert_tree(got, want, rtol):
    """A port dict (tensor leaves, or nested dicts) against the
    reference's, each leaf at ``rtol`` with an atol of ``rtol`` times its
    largest value."""
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], rtol)
            continue
        w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if g.dtype == torch.bfloat16:
            # one bfloat16 step (2^-7 relative) at the leaf's scale
            step = 2.0 ** -7 * float(np.max(np.abs(w)))
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2.0 ** -7,
                                       atol=step, err_msg=k)
        else:
            assert g.dtype == torch.float32, k
            atol = rtol * float(np.max(np.abs(w))) if w.size else 0.0
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                                       err_msg=k)


CASES = [
    ("sgd", lambda m: m.SGD(lr=1e-2, momentum=0.9), 1e-6),
    ("adamw", lambda m: m.AdamW(lr=m.cosine_schedule(3e-3, 2, 10),
                                weight_decay=0.1), 1e-6),
    ("adamw_const", lambda m: m.AdamW(lr=1e-3, b2=0.99, eps=1e-7), 1e-6),
    ("adafactor", lambda m: m.Adafactor(lr=1e-2), 1e-5),
]


@pytest.mark.parametrize("name, make, rtol", CASES, ids=[c[0] for c in CASES])
def test_three_steps_match_reference(name, make, rtol):
    import repro_torch.optim as P

    ref_opt, port_opt = make(R), make(P)
    values_np = _tree(1)
    rv, pv = _ref(values_np), _port(values_np)
    rs, ps = ref_opt.init(rv), port_opt.init(pv)
    _assert_tree(ps, jax.tree.map(np.asarray, rs), rtol)
    ref_step = jax.jit(ref_opt.step)
    for step in range(3):
        grads_np = _tree(10 + step, scale=0.5)
        rv, rs = ref_step(rv, _ref(grads_np), rs, step)
        pv, ps = port_opt.step(pv, _port(grads_np), ps, step)
        _assert_tree(pv, rv, rtol)
        _assert_tree(ps, rs, rtol)


def test_adafactor_factored_state_shapes_equal_reference():
    values_np = _tree(2)
    rs = R.Adafactor().init(_ref(values_np))
    ps = Adafactor().init(_port(values_np))
    shapes = jax.tree.map(lambda a: tuple(a.shape), rs)
    assert {k: {kk: tuple(t.shape) for kk, t in v.items()}
            for k, v in ps["v"].items()} == shapes["v"]
    assert set(ps["v"]["w"]) == {"vr", "vc"}
    assert set(ps["v"]["t3"]) == {"vr", "vc"}
    assert set(ps["v"]["small"]) == {"v"}
    assert all(t.dtype == torch.float32
               for v in ps["v"].values() for t in v.values())


def test_adamw_state_is_float32_for_a_bf16_leaf():
    values = _port(_tree(3))
    state = AdamW().init(values)
    assert state["m"]["half"].dtype == torch.float32
    new, _ = AdamW().step(values, _port(_tree(4)), state, 0)
    assert new["half"].dtype == torch.bfloat16


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    grads_np = _tree(5, scale=0.1)
    want_norm = R.global_norm(_ref(grads_np))
    np.testing.assert_allclose(float(global_norm(_port(grads_np))),
                               float(want_norm), rtol=1e-6)
    ref_clipped, ref_norm = R.clip_by_global_norm(_ref(grads_np), max_norm)
    clipped, norm = clip_by_global_norm(_port(grads_np), max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    _assert_tree(clipped, ref_clipped, 1e-6)
    assert clipped["half"].dtype == torch.bfloat16


@pytest.mark.parametrize("base, warmup, total, min_frac",
                         [(3e-3, 20, 100, 0.1), (1e-2, 0, 7, 0.0),
                          (5e-4, 3, 3, 0.5)])
def test_cosine_schedule_matches_reference(base, warmup, total, min_frac):
    ref_lr = R.cosine_schedule(base, warmup, total, min_frac)
    lr = cosine_schedule(base, warmup, total, min_frac)
    for step in range(total + 2):
        got, want = lr(step), float(ref_lr(step))
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=str(step))


def test_make_optimizer_names_and_defaults():
    assert make_optimizer("AdamW") == AdamW(lr=3e-4)
    assert make_optimizer("adafactor") == Adafactor(lr=1e-2)
    assert make_optimizer("sgd", lr=0.5, momentum=0.0) == SGD(lr=0.5,
                                                            momentum=0.0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb")
