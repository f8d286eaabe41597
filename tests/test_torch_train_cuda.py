"""The backward kernels of the training path on the card against their
plain versions, and a float32 train step on the card against the CPU's.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Every test needs a card and skips without one. Tolerances are those of
``tests/test_kernels.py:22-23`` (float32 2e-3, bfloat16 3e-2), applied to
a gradient as max|got - want| <= tol * (1 + max|want|). Every kernel call
is made twice and held bitwise (no float atomics): the bfloat16 attention
backward over D in {16, 32, 64, 128}, G in {1, 3, 4}, S in {1, 63, 64, 77,
256}, causal and not; the rmsnorm backward in each of its layouts (rows,
block, scalar, an offset view among them).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain
from repro_torch.kernels.rmsnorm.ops import (
    bwd_plan,
    rmsnorm,
    rmsnorm_bwd,
    rmsnorm_pair_bwd,
)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_plain
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.trainer import make_train_step, master_values

TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]
ATTN_SHAPES = [  # (B, H, K, S, D, causal)
    (2, 9, 3, 77, 64, True),      # SmolLM's heads, ragged S
    (1, 32, 8, 200, 128, True),   # Qwen3's, G = 4
    (2, 4, 4, 64, 16, True),      # G = 1, one whole tile
    (2, 16, 16, 130, 64, False),  # the Seamless encoder's (non-causal)
    (1, 8, 2, 33, 32, False),
]

# The bfloat16 tensor-core backward over every head dim, GQA group, a
# ragged, a whole and a one-position S, causal and not: (D, G, S, causal).
BF16_GRID = [(d, g, s, causal) for d in (16, 32, 64, 128) for g in (1, 3, 4)
             for s in (1, 63, 64, 77, 256) for causal in (True, False)]
# rmsnorm backward rows reaching each layout in bfloat16: (rows, D, offset
# of the view in elements, layout); float32 runs the same rows
RMS_LAYOUTS = [
    (2048, 512, 0, "rows"), (4096, 128, 0, "rows"), (7, 16, 0, "rows"),
    (2048, 576, 0, "block"),
    (2048, 4096, 0, "block"), (1000, 3072, 0, "block"),
    (64, 7168, 0, "block"), (300, 100, 0, "scalar"), (129, 256, 1, "scalar"),
    (257, 1030, 0, "scalar"), (40, 16384, 0, "scalar"),
]

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, shift=0.0, dtype=torch.float32,
           device="cpu"):
    a = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return torch.from_numpy(a).to(dtype).to(device)


def _close(name, got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all(), name
    err = float((got - want).abs().max())
    bound = TOL[dtype] * (1.0 + float(want.abs().max()))
    assert err <= bound, f"{name}: max abs err {err} beyond {bound}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t, d", [(2048, 576), (1000, 4096), (3, 128),
                                  (64, 7168)])
def test_rmsnorm_bwd_kernel_matches_plain(card, t, d, dtype):
    rng = np.random.default_rng(t + d)
    x = _randn(rng, t, d, scale=3.0, dtype=dtype, device=card)
    g = _randn(rng, d, scale=0.2, shift=1.0, dtype=dtype, device=card)
    dy = _randn(rng, t, d, dtype=dtype, device=card)
    reset_launch_counts()
    dx, dg = rmsnorm_bwd(x, g, dy)
    torch.cuda.synchronize()
    assert launch_counts["rmsnorm_bwd"] == 2
    want_dx, want_dg = rmsnorm_bwd_plain(x, g, dy)
    assert dx.dtype == dtype and dg.dtype == torch.float32
    _close("dx", dx, want_dx, dtype)
    _close("dgain", dg, want_dg, dtype)
    dx2, dg2 = rmsnorm_bwd(x, g, dy)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2)  # bitwise


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_pair_bwd_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(3)
    xq, dyq = (_randn(rng, 4096, 128, dtype=dtype, device=card)
               for _ in range(2))
    xk, dyk = (_randn(rng, 1024, 128, dtype=dtype, device=card)
               for _ in range(2))
    gq, gk = (_randn(rng, 128, scale=0.2, shift=1.0, dtype=dtype,
                     device=card) for _ in range(2))
    reset_launch_counts()
    got = rmsnorm_pair_bwd(xq, gq, dyq, xk, gk, dyk)
    assert launch_counts["rmsnorm_bwd"] == 2
    want = (*rmsnorm_bwd_plain(xq, gq, dyq), *rmsnorm_bwd_plain(xk, gk, dyk))
    for name, a, b in zip(("dxq", "dgq", "dxk", "dgk"), got, want):
        _close(name, a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_bwd_kernel_matches_plain(card, shape, dtype):
    b, h, kh, s, d, causal = shape
    rng = np.random.default_rng(sum(shape[:5]))
    # the model's layout: [B, H, S, D] views of [B, S, H, D] tensors
    q, o, do = (_randn(rng, b, s, h, d, dtype=dtype,
                       device=card).transpose(1, 2) for _ in range(3))
    k, v = (_randn(rng, b, s, kh, d, dtype=dtype,
                   device=card).transpose(1, 2) for _ in range(2))
    o = flash_attention(q, k, v, causal=causal)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_bwd"] == 2
    want = flash_attention_bwd_plain(q, k, v, o, do, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        _close(name, a, w, dtype)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal)
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)  # no atomics: bitwise


@pytest.mark.parametrize("d, g, s, causal", BF16_GRID,
                         ids=lambda v: str(v))
def test_flash_attention_bwd_tensor_cores(card, d, g, s, causal):
    b, kh = 2, 2
    h = g * kh
    rng = np.random.default_rng(d * 1000 + g * 100 + s + int(causal))
    dtype = torch.bfloat16
    q, do = (_randn(rng, b, s, h, d, dtype=dtype,
                    device=card).transpose(1, 2) for _ in range(2))
    k, v = (_randn(rng, b, s, kh, d, dtype=dtype,
                   device=card).transpose(1, 2) for _ in range(2))
    o = flash_attention(q, k, v, causal=causal)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, do, causal=causal)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_bwd"] == 4
    want = flash_attention_bwd_plain(q, k, v, o, do, causal)
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.shape == w.shape and a.is_contiguous()
        _close(name, a, w, dtype)
        assert torch.equal(a, a2)  # no atomics: bitwise


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t, d, offset, layout", RMS_LAYOUTS, ids=str)
def test_rmsnorm_bwd_every_layout(card, t, d, offset, layout, dtype):
    rng = np.random.default_rng(t * 7 + d)
    flat = _randn(rng, t * d + offset, scale=3.0, dtype=dtype, device=card)
    x = flat[offset:].view(t, d)
    g = _randn(rng, d, scale=0.2, shift=1.0, dtype=dtype, device=card)
    dy = _randn(rng, t, d, dtype=dtype, device=card)
    aligned = all(z.data_ptr() % 16 == 0 for z in (x, g, dy))
    if dtype == torch.bfloat16:
        assert bwd_plan(t, d, dtype, aligned)[0] == layout
    reset_launch_counts()
    dx, dg = rmsnorm_bwd(x, g, dy)
    dx2, dg2 = rmsnorm_bwd(x, g, dy)
    torch.cuda.synchronize()
    assert launch_counts["rmsnorm_bwd"] == 4
    want_dx, want_dg = rmsnorm_bwd_plain(x, g, dy)
    _close("dx", dx, want_dx, dtype)
    _close("dgain", dg, want_dg, dtype)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2)  # bitwise


@pytest.mark.parametrize("name", ["q", "k", "v", "out", "dout"])
def test_flash_attention_bwd_raises_on_misaligned_bf16(card, name):
    b, h, kh, s, d = 1, 4, 2, 40, 32
    rng = np.random.default_rng(1)
    t = {n: _randn(rng, b, s, heads, d, dtype=torch.bfloat16,
                   device=card).transpose(1, 2)
         for n, heads in (("q", h), ("k", kh), ("v", kh), ("out", h),
                          ("dout", h))}
    # the same values at a position stride of d + 1 elements
    bad = torch.zeros(b, t[name].shape[1], s, d + 1, dtype=torch.bfloat16,
                      device=card)[..., :d]
    bad.copy_(t[name])
    t[name] = bad
    with pytest.raises(ValueError, match=f"^{name} .*16 bytes"):
        flash_attention_bwd(t["q"], t["k"], t["v"], t["out"], t["dout"])


def test_function_backward_copies_an_unaligned_dout(card):
    """Autograd hands the backward an output gradient with rows off 16
    bytes: the Function copies it, and the kernel's gradient equals the
    one of an aligned copy bitwise."""
    b, h, kh, s, d = 2, 4, 2, 48, 64
    rng = np.random.default_rng(2)
    q = _randn(rng, b, s, h, d, dtype=torch.bfloat16,
               device=card).transpose(1, 2).requires_grad_(True)
    k, v = (_randn(rng, b, s, kh, d, dtype=torch.bfloat16,
                   device=card).transpose(1, 2).requires_grad_(True)
            for _ in range(2))
    out = flash_attention(q, k, v)
    do = torch.zeros(b, h, s, d + 1, dtype=torch.bfloat16,
                     device=card)[..., :d]
    do.copy_(_randn(rng, b, h, s, d, dtype=torch.bfloat16, device=card))
    out.backward(do)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                               out.detach(), do.contiguous())
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


def test_functions_launch_the_backward_kernels(card):
    rng = np.random.default_rng(9)
    x = _randn(rng, 16, 64, device=card).requires_grad_(True)
    g = _randn(rng, 64, shift=1.0, device=card).requires_grad_(True)
    q = _randn(rng, 1, 4, 20, 32, device=card).requires_grad_(True)
    k = _randn(rng, 1, 2, 20, 32, device=card).requires_grad_(True)
    v = _randn(rng, 1, 2, 20, 32, device=card).requires_grad_(True)
    reset_launch_counts()
    with torch.inference_mode():  # serving: the direct path only
        rmsnorm(x, g)
        flash_attention(q, k, v)
    assert dict(launch_counts) == {"rmsnorm": 1, "flash_attention": 1}
    reset_launch_counts()
    loss = rmsnorm(x, g).square().sum() + flash_attention(q, k, v).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert dict(launch_counts) == {"rmsnorm": 1, "flash_attention": 1,
                                   "rmsnorm_bwd": 2,
                                   "flash_attention_bwd": 2}
    assert all(t.grad is not None for t in (x, g, q, k, v))


def test_backward_wrappers_raise_on_bad_inputs(card):
    x = torch.ones(4, 8, device=card)
    with pytest.raises(TypeError):
        rmsnorm_bwd(x, torch.ones(8, device=card, dtype=torch.bfloat16), x)
    with pytest.raises(ValueError):
        rmsnorm_bwd(x, torch.ones(8, device=card), torch.ones(4, 9,
                                                              device=card))
    q = torch.ones(1, 2, 8, 24, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, q, q, q, q)
    q = torch.ones(1, 3, 8, 16, device=card)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bwd(q, q[:, :2], q[:, :2], q, q)


def test_smollm_train_step_card_matches_cpu(card):
    """One float32 AdamW step of the SMOKE SmolLM (every exit) on the card
    against the CPU: loss, every gradient-driven value."""
    cfg = get_config("smollm-135m", smoke=True)
    cpu = build_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = build_model(cfg, torch.Generator(device=card).manual_seed(0),
                      device=card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(
        np.int32))
    opt = AdamW(lr=1e-3)
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, card)):
        values = master_values(model)
        batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        reset_launch_counts()
        out[name] = make_train_step(model, opt)(values, opt.init(values),
                                                batch, 0)
        out[name + "_counts"] = dict(launch_counts)
    layers, exits = cfg.num_layers, cfg.num_exits
    assert out["cuda_counts"] == {
        "rmsnorm": 2 * layers + exits, "flash_attention": layers,
        "rmsnorm_bwd": 2 * (2 * layers + exits),
        "flash_attention_bwd": 2 * layers}
    assert float(out["cuda"][2]["loss"]) == pytest.approx(
        float(out["cpu"][2]["loss"]), rel=1e-5)
    for name, want in out["cpu"][0].items():
        _close(name, out["cuda"][0][name], want, torch.float32)
