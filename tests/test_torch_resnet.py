"""The port's early-exit ResNets against the JAX reference on the CPU: the
reference's weights (``jax.random.key(0)``) converted by
``resnet_params_from_jax``, the same seeded images, every exit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.edgeserving_resnets import FULL as REF_FULL
from repro.configs.edgeserving_resnets import SMOKE as REF_SMOKE
from repro.models import EarlyExitResNet as RefResNet
from repro.models import split_params

from repro_torch.configs import FULL, SMOKE
from repro_torch.models import EarlyExitResNet, resnet_params_from_jax
from repro_torch.models.resnet import norm_groups, same_pads

TOL = dict(rtol=2e-3, atol=2e-3)


def _pair(ref_cfg, cfg, key=0):
    """(reference model, its values, port model with the converted values)."""
    ref = RefResNet(ref_cfg)
    values, _ = split_params(ref.init(jax.random.key(key)))
    values_np = jax.tree.map(np.asarray, values)
    port = EarlyExitResNet(cfg, device="cpu").eval()
    port.load_state_dict(resnet_params_from_jax(values_np, cfg))
    return ref, values, port


@pytest.fixture(scope="module", params=sorted(SMOKE))
def smoke_pair(request):
    name = request.param
    return _pair(REF_SMOKE[name], SMOKE[name])


@pytest.mark.parametrize("exit_idx", range(4))
@pytest.mark.parametrize("batch", [1, 3])
def test_smoke_exits_match_reference(smoke_pair, exit_idx, batch):
    ref, values, port = smoke_pair
    x = np.random.default_rng(exit_idx * 10 + batch).normal(
        size=(batch, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ref.forward_exit(values, jnp.asarray(x), exit_idx))
    with torch.inference_mode():
        got = port.forward_exit(torch.from_numpy(x), exit_idx)
    assert got.dtype == torch.float32 and got.shape == (batch, 100)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.fixture(scope="module")
def full_resnet50():
    return _pair(REF_FULL["resnet50"], FULL["resnet50"])


@pytest.mark.parametrize("exit_idx", [0, 1])
def test_full_width_resnet50_matches_reference(full_resnet50, exit_idx):
    """Real channel counts, and exit 1 runs the stride-2 3x3 conv whose XLA
    SAME padding is (0, 1)."""
    ref, values, port = full_resnet50
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(ref.forward_exit(values, jnp.asarray(x), exit_idx))
    with torch.inference_mode():
        got = port.forward_exit(torch.from_numpy(x), exit_idx)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (31, 3, 2), (32, 1, 2),
                                           (16, 3, 1), (8, 1, 1), (5, 4, 3)])
def test_same_pads_match_xla(size, k, stride):
    lo, hi = same_pads(size, k, stride)
    x = np.arange(size, dtype=np.float32).reshape(1, size, 1, 1)
    w = np.ones((k, 1, 1, 1), np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                (0, 0, lo, hi)),
        torch.ones((1, 1, k, 1)), stride=(stride, 1))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("c,want", [(8, 8), (64, 8), (12, 6), (3, 3),
                                    (2048, 8)])
def test_norm_groups_rule(c, want):
    assert norm_groups(c, 8) == want


def test_same_seed_same_weights_and_projection_layout():
    a = EarlyExitResNet(SMOKE["resnet50"], device="cpu")
    b = EarlyExitResNet(SMOKE["resnet50"], device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # layer1 block 0 changes channels (cin != cout): it has a projection
    assert a.layer1[0].proj is not None
    assert a.layer1[0].proj.stride == 1 and a.layer2[0].proj.stride == 2
    # init scales: conv 1/sqrt(k*k*cin), heads 1/sqrt(C), truncated at 2 std
    w = a.stem.weight.detach()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(27) + 1e-6


def test_state_dict_keys_match_conversion():
    cfg = SMOKE["resnet152"]
    _, _, port = _pair(REF_SMOKE["resnet152"], cfg)
    ref_keys = set(port.state_dict())
    ref = RefResNet(REF_SMOKE["resnet152"])
    values, _ = split_params(ref.init(jax.random.key(1)))
    sd = resnet_params_from_jax(jax.tree.map(np.asarray, values), cfg)
    assert set(sd) == ref_keys


def test_model_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EarlyExitResNet(SMOKE["resnet50"])
