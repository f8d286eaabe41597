"""The port's Mamba block and the Jamba hybrid against the JAX reference
on the CPU: the causal conv's window and the selective scan's ``h`` carried
across decode steps, and the Jamba SMOKE model (attention, Mamba and MoE
sublayers) through every entry point with its mixed cache.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.mamba import MambaConfig as RefMambaConfig
from repro.models.mamba import _causal_conv as ref_causal_conv
from repro.models.mamba import mamba as ref_mamba

from repro_torch.configs import get_config
from repro_torch.models.jamba_model import sub_kinds
from repro_torch.models.mamba import (
    MambaConfig,
    _causal_conv,
    init_mamba,
    mamba,
)

from torch_zoo import TOL, FamilyChecks

torch.set_num_threads(1)

KW = dict(d_model=16, d_state=4, d_conv=3, expand=2)


def _params(seed):
    p = init_mamba(torch.Generator().manual_seed(seed), MambaConfig(**KW))
    rng = np.random.default_rng(seed)
    # non-zero biases so that a bias applied wrong shows
    for key in ("conv_b", "dt_bias"):
        p[key].data = torch.from_numpy(
            0.3 * rng.normal(size=p[key].shape).astype(np.float32))
    return p, {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}


def test_a_log_is_the_s4d_real_init():
    p, _ = _params(0)
    want = np.log(np.arange(1, 5, dtype=np.float32))
    np.testing.assert_allclose(p["a_log"].numpy(),
                               np.broadcast_to(want, (32, 4)), rtol=1e-7)


@pytest.mark.parametrize("window", [False, True])
def test_causal_conv_matches_reference(window):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    w = rng.normal(size=(3, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    win = rng.normal(size=(2, 2, 6)).astype(np.float32) if window else None
    want, want_win = ref_causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if win is None else jnp.asarray(win))
    got, got_win = _causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if win is None else torch.from_numpy(win))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(want_win))


def test_state_carried_across_decode_equals_the_whole_sequence():
    """Prefill 4 tokens, then 3 one-token steps carrying ``h`` and the
    conv window: each step's output equals the reference's step and the
    port's own output over all 7 tokens at that position."""
    p, pj = _params(2)
    cfg, ref_cfg = MambaConfig(**KW), RefMambaConfig(**KW)
    x = np.random.default_rng(3).normal(size=(2, 7, 16)).astype(np.float32)
    whole, _ = mamba(p, torch.from_numpy(x), cfg)
    out, state = mamba(p, torch.from_numpy(x[:, :4]), cfg)
    ref_out, ref_state = ref_mamba(pj, jnp.asarray(x[:, :4]), ref_cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    assert state["h"].dtype == torch.float32
    for t in range(4, 7):
        out, state = mamba(p, torch.from_numpy(x[:, t:t + 1]), cfg, state)
        ref_out, ref_state = ref_mamba(pj, jnp.asarray(x[:, t:t + 1]),
                                       ref_cfg, ref_state)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
        np.testing.assert_allclose(out[:, 0].numpy(), whole[:, t].numpy(),
                                   **TOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(ref_state[key]), **TOL)
        assert state["h"].dtype == torch.float32


class TestJamba(FamilyChecks):
    ARCH = "jamba-v0.1-52b"


@pytest.mark.parametrize("smoke", [True, False])
def test_jamba_sublayer_kinds_follow_the_reference(smoke):
    ref = ref_build_model(ref_get_config("jamba-v0.1-52b", smoke))
    assert sub_kinds(get_config("jamba-v0.1-52b", smoke)) == ref._sub_kinds()
