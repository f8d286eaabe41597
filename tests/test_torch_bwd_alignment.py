"""The 16-byte row rule of the bfloat16 attention kernels, on the CPU:
``checks.require_16_byte_rows`` flags a bad base address or stride of each
tensor the backward takes, and ``_FlashAttention``'s backward hands the
backward wrapper a copy of an output gradient that breaks the rule, which
changes no bit of the gradient.

The card's side (the wrapper raising, the kernel on a copied gradient) is
in ``tests/test_torch_train_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import checks
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain

B, H, K, S, D = 2, 4, 2, 24, 32
SHAPES = {"q": (B, H, S, D), "k": (B, K, S, D), "v": (B, K, S, D),
          "out": (B, H, S, D), "dout": (B, H, S, D)}


def _views(shape, dtype=torch.bfloat16):
    """Views of ``shape`` whose rows do not start on 16 bytes: a position
    stride, a head stride and a batch stride that are not multiples of 16
    bytes, and a base address one element past an aligned one."""
    b, h, s, d = shape
    pos = torch.zeros(b, h, s, d + 1, dtype=dtype)[..., :d]
    head = torch.zeros(b, h, s * d + 2, dtype=dtype)[..., : s * d].view(
        b, h, s, d)
    batch = torch.zeros(b, h * s * d + 2, dtype=dtype)[:, : h * s * d].view(
        b, h, s, d)
    base = torch.zeros(b * h * s * d + 1, dtype=dtype)[1:].view(b, h, s, d)
    return {"position": pos, "head": head, "batch": batch, "base": base}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("how", ["position", "head", "batch", "base"])
def test_require_16_byte_rows_flags_each_tensor(name, how):
    bad = _views(SHAPES[name])[how]
    assert not checks.has_16_byte_rows(bad)
    with pytest.raises(ValueError, match=f"^{name} "):
        checks.require_16_byte_rows(bad, name)
    good = torch.zeros(SHAPES[name], dtype=torch.bfloat16)
    checks.require_16_byte_rows(good, name)  # no raise
    # the model's [B, H, S, D] view of a [B, S, H, D] tensor passes
    b, h, s, d = SHAPES[name]
    checks.require_16_byte_rows(
        torch.zeros(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2), name)


def test_a_size_one_dimension_never_uses_its_stride():
    t = torch.zeros(1, 4, 8, 16 + 3, dtype=torch.bfloat16)[:, :1, :, :16]
    # batch and head of size 1: only the position stride (19) counts
    assert not checks.has_16_byte_rows(t)
    t = torch.zeros(3, 1, 8, 16, dtype=torch.bfloat16)[:1]
    assert checks.has_16_byte_rows(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["position", "head", "batch", "base"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_hands_the_kernel_an_aligned_dout(monkeypatch, dtype, how,
                                                   causal):
    """The output gradient that ``_FlashAttention.backward`` passes on to
    ``flash_attention_bwd`` starts every row on 16 bytes, whatever the
    caller's; the gradient keeps the plain backward's bits."""
    handed = []

    def spy(q, k, v, out, dout, causal):
        handed.append(dout)
        return wrapper(q, k, v, out, dout, causal=causal)

    wrapper = fa_ops.flash_attention_bwd
    monkeypatch.setattr(fa_ops, "flash_attention_bwd", spy)
    rng = np.random.default_rng(7)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)

    q = randn(B, S, H, D).transpose(1, 2).requires_grad_(True)
    k = randn(B, S, K, D).transpose(1, 2).requires_grad_(True)
    v = randn(B, S, K, D).transpose(1, 2).requires_grad_(True)
    out = flash_attention(q, k, v, causal=causal)
    dout = _views((B, H, S, D), dtype)[how]
    dout.copy_(randn(B, H, S, D))
    assert not checks.has_16_byte_rows(dout)
    out.backward(dout)
    assert len(handed) == 1 and checks.has_16_byte_rows(handed[0])
    assert torch.equal(handed[0], dout)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                     out.detach(), dout, causal)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == w.dtype and torch.equal(got, w)
