"""The port's RWKV-6 against the JAX reference on the CPU: the WKV
recurrence stepwise and chunked (chunks of 2 and 4, from a carried state),
and the RWKV6-1.6B SMOKE model through every entry point with the stepwise
scan (the served config) and with the chunked form, which also equals the
reference's scan.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.rwkv6 import _wkv_chunked as ref_wkv_chunked
from repro.models.rwkv6 import _wkv_scan as ref_wkv_scan

from repro_torch.models import build_model
from repro_torch.models.rwkv6 import _wkv_chunked, _wkv_scan

from torch_zoo import TOL, FamilyChecks, ZooPair, assert_trees_close

torch.set_num_threads(1)


def _wkv_inputs(seed, b=2, s=8, h=3, n=4):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, s, h, n)))).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    state = (0.3 * rng.normal(size=(b, h, n, n))).astype(np.float32)
    return r, k, v, w, u, state


@pytest.mark.parametrize("carried", [False, True])
def test_wkv_scan_matches_reference(carried):
    r, k, v, w, u, state = _wkv_inputs(0)
    st = state if carried else None
    want, want_state = ref_wkv_scan(
        *map(jnp.asarray, (r, k, v, w, u)),
        None if st is None else jnp.asarray(st))
    got, got_state = _wkv_scan(
        *map(torch.from_numpy, (r, k, v, w, u)),
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               **TOL)
    assert got_state.dtype == torch.float32


@pytest.mark.parametrize("chunk", [2, 4])
def test_wkv_chunked_matches_reference_and_the_scan(chunk):
    r, k, v, w, u, state = _wkv_inputs(chunk)
    want, want_state = ref_wkv_chunked(
        *map(jnp.asarray, (r, k, v, w, u, state)), chunk=chunk)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, state)]
    got, got_state = _wkv_chunked(*args, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               **TOL)
    scan, scan_state = _wkv_scan(*args)
    np.testing.assert_allclose(got.numpy(), scan.numpy(), **TOL)
    np.testing.assert_allclose(got_state.numpy(), scan_state.numpy(), **TOL)


def test_wkv_chunked_needs_whole_chunks():
    args = [torch.from_numpy(a) for a in _wkv_inputs(1, s=6)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        _wkv_chunked(*args, chunk=4)


class TestRWKV6(FamilyChecks):
    ARCH = "rwkv6-1.6b"


def _gentle_decay(values_np):
    """Decay logits near -1 (w near 0.69 a step), as trained RWKV models
    have them: the seeded ones reach e^-60 inside a chunk, where the
    chunked form's clamp (the reference's) no longer equals the scan."""
    for seg in values_np["segments"]:
        seg["tm"]["decay_base"][...] = -1.0


class TestRWKV6Chunked(FamilyChecks):
    """The chunked WKV in every prefill (12 tokens: three chunks of 4) on
    both sides, the scan in decode."""
    ARCH = "rwkv6-1.6b"
    OVERRIDES = dict(rwkv_chunk=4)
    SEQ = 12

    @pytest.fixture(scope="class")
    def pair(self):
        return ZooPair(self.ARCH, seq=self.SEQ, edit_values=_gentle_decay,
                       **self.OVERRIDES)


def test_chunked_model_equals_the_scan():
    scan = ZooPair("rwkv6-1.6b", seq=12, edit_values=_gentle_decay)
    chunked = build_model(dataclasses.replace(scan.cfg, rwkv_chunk=4),
                          device="cpu")
    chunked.load_state_dict(scan.port.state_dict())
    for e in range(scan.cfg.num_exits):
        with torch.inference_mode():
            got = chunked.forward_exit(scan.batch(), e)
            _, states = chunked.prefill(scan.batch(), e)
        np.testing.assert_allclose(got.numpy(),
                                   scan.ref_out("forward_exit", e), **TOL)
        assert_trees_close(states, scan.ref_out("prefill", e)[1])
