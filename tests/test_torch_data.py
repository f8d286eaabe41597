"""The port's synthetic data streams against the reference's on the CPU:
the same seed gives the same batches, element for element (the draws are
the same numpy ``Generator`` calls in the same order), as int32 tokens and
labels and float32 embeddings and images on the requested device."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as R

from repro_torch.data import (
    cifar100_like,
    synthetic_lm_batches,
    synthetic_memorization_corpus,
)

DTYPES = {"tokens": torch.int32, "labels": torch.int32,
          "src_embeds": torch.float32, "embeds": torch.float32}


def _equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == DTYPES[k], k
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(vocab=61, batch=3, seq=9, seed=0),
    dict(vocab=49152, batch=2, seq=17, seed=5),
    dict(vocab=100, batch=2, seq=8, seed=1, encdec=True, d_model=12,
         src_len=5),
    dict(vocab=100, batch=2, seq=8, seed=2, vision=True, d_model=10),
], ids=["small", "smollm_vocab", "encdec", "vision"])
def test_lm_batches_equal_reference_for_three_draws(kw):
    ref = R.synthetic_lm_batches(**kw)
    port = synthetic_lm_batches(**kw, device="cpu")
    for _ in range(3):
        _equal(next(port), next(ref))


@pytest.mark.parametrize("batch, classes, seed", [(8, 100, 0), (5, 10, 3)])
def test_cifar100_like_equals_reference(batch, classes, seed):
    imgs, labels = cifar100_like(batch, classes, seed, device="cpu")
    ref_imgs, ref_labels = R.cifar100_like(batch, classes, seed)
    assert imgs.dtype == torch.float32 and labels.dtype == torch.int32
    assert imgs.shape == (batch, 32, 32, 3)
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(ref_imgs))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))


def test_memorization_corpus_equals_reference():
    got = synthetic_memorization_corpus(256, n=4, seq=16, seed=3,
                                        device="cpu")
    _equal(got, R.synthetic_memorization_corpus(256, n=4, seq=16, seed=3))


def test_streams_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(synthetic_lm_batches(vocab=10, batch=1, seq=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cifar100_like(2)
