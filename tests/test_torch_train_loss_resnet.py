"""The smoke ResNet-50's ``train_loss`` against the reference's on the
CPU: the loss, every ``nll_exit{i}`` and ``acc_exit{i}`` at rtol 1e-5, and
every parameter's gradient, carried across by name
(``resnet_params_from_jax``), against ``jax.grad`` at 2e-3 * (1 + the
leaf's largest gradient) (``torch_train``); the exit weights normalised."""

import numpy as np
import pytest
import torch

from repro.configs.edgeserving_resnets import SMOKE as REF_SMOKE

from repro_torch.configs import SMOKE

from torch_train import (
    LOSS_RTOL,
    ResNetPair,
    assert_grad_close,
    port_loss_and_grads,
    ref_loss_and_grads,
    to_torch,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def resnet_case():
    pair = ResNetPair(REF_SMOKE["resnet50"], SMOKE["resnet50"])
    want = ref_loss_and_grads(pair)
    got = port_loss_and_grads(pair.port, to_torch(pair.batch_np))
    return pair, want, got


def test_resnet_loss_and_accuracies_match_reference(resnet_case):
    _, (ref_loss, ref_metrics, _), (loss, metrics, _) = resnet_case
    assert set(metrics) == set(ref_metrics)
    np.testing.assert_allclose(float(loss.detach()), ref_loss,
                               rtol=LOSS_RTOL)
    for key, want in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[key].detach()), want,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)


def test_resnet_every_parameter_gradient_matches_reference(resnet_case):
    _, (_, _, ref_grads), (_, _, grads) = resnet_case
    assert set(grads) == set(ref_grads)
    assert all(g is not None for g in grads.values())
    for name, want in ref_grads.items():
        assert_grad_close(name, grads[name].numpy(), want)


def test_resnet_exit_weights_are_normalised():
    pair = ResNetPair(REF_SMOKE["resnet50"], SMOKE["resnet50"], batch=2)
    batch = to_torch(pair.batch_np)
    with torch.inference_mode():
        loss, metrics = pair.port.train_loss(batch, exit_weights=(0, 0, 0, 2))
    assert float(loss) == pytest.approx(float(metrics["nll_exit3"]),
                                        rel=1e-6)
