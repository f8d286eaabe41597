"""The port's int8 collectives against the JAX reference on the CPU:
``quantize_int8``, ``dequantize_int8`` and ``quantize_tree`` bitwise in
float32 (both round half to even), ``compressed_psum`` over gloo with one
rank in this process and with two spawned ranks, and the cases of
``tests/test_runtime.py::TestGradCompression`` (fixed seeds in place of
hypothesis). ``TrainConfig.compress_grads`` stays unread, as in the
reference."""

import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import collectives as RC

from repro_torch.distributed.collectives import (
    compressed_psum,
    dequantize_int8,
    quantize_int8,
    quantize_tree,
)

from torch_dist import psum_worker

torch.set_num_threads(1)


def _draw(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


CASES = [(0, (128,), 5.0), (1, (64, 33), 1e-3), (2, (7,), 1e4),
         (3, (16, 16), 1.0)]


@pytest.mark.parametrize("seed,shape,scale", CASES)
def test_quantize_dequantize_bitwise(seed, shape, scale):
    x = _draw(seed, shape, scale)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(RC.dequantize_int8(rq, rs)))


def test_round_half_to_even_and_zero_input():
    # 127 * {0.5, 1.5, 2.5} / 127 rounds to even on both sides
    x = np.array([127.0, 0.5, 1.5, 2.5, -2.5, 0.0], np.float32)
    q, _ = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(RC.quantize_int8(x)[0]))
    assert q.tolist() == [127, 0, 2, 2, -2, 0]
    z = np.zeros(5, np.float32)
    q, s = quantize_int8(torch.from_numpy(z))
    assert s.item() == float(RC.quantize_int8(z)[1]) and not q.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tree_bitwise_over_steps(dtype):
    tdt = getattr(torch, dtype)
    grads = {"a": _draw(4, (32, 8), 1e-3), "b": _draw(5, (17,), 3.0)}
    port_err, ref_err = None, None
    for step in range(4):
        g = {k: torch.from_numpy(v * (step + 1)).to(tdt)
             for k, v in grads.items()}
        rg = {k: jnp.asarray(v.to(torch.float32).numpy()).astype(dtype)
              for k, v in g.items()}
        deq, scales, port_err = quantize_tree(g, port_err)
        rdeq, rscales, ref_err = RC.quantize_tree(rg, ref_err)
        for k in grads:
            assert deq[k].dtype == tdt
            np.testing.assert_array_equal(
                deq[k].to(torch.float32).numpy(),
                np.asarray(rdeq[k]).astype(np.float32))
            assert scales[k].item() == float(rscales[k])
            np.testing.assert_array_equal(port_err[k].numpy(),
                                          np.asarray(ref_err[k]))


def test_compressed_psum_one_rank_in_process():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for seed, shape, scale in CASES:
            x = torch.from_numpy(_draw(seed, shape, scale))
            got = compressed_psum(x)
            assert torch.equal(got, dequantize_int8(*quantize_int8(x)))
            rq, rs = RC.quantize_int8(jnp.asarray(x.numpy()))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(RC.dequantize_int8(rq, rs)))
        bf = torch.from_numpy(_draw(9, (40,))).to(torch.bfloat16)
        assert compressed_psum(bf).dtype == torch.bfloat16
    finally:
        dist.destroy_process_group()


def test_compressed_psum_two_ranks(tmp_path):
    inputs = [_draw(10, (64, 5), 2.0), _draw(11, (64, 5), 0.5)]
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "out")
    procs = [ctx.Process(target=psum_worker,
                         args=(r, 2, str(tmp_path / "store"), inputs, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0, 0]
    # the reference's arithmetic on the same inputs: int32 sum of the int8
    # payloads, dequantised with the larger scale
    qs = [RC.quantize_int8(jnp.asarray(x)) for x in inputs]
    q_sum = sum(np.asarray(q, np.int32) for q, _ in qs)
    scale = max(float(s) for _, s in qs)
    want = np.asarray(RC.dequantize_int8(jnp.asarray(q_sum),
                                         jnp.float32(scale)))
    for rank in range(2):
        res = torch.load(f"{out}.{rank}")
        np.testing.assert_array_equal(res["psum"].numpy(), want)
        # two surviving ranks, model axis 1: a 2 x 1 mesh, accumulation 8
        assert res["mesh"] == (2, 1) and res["accum"] == 8


# -- the cases of tests/test_runtime.py::TestGradCompression ------------------


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(_draw(0, (128,), 5.0))
    q, scale = quantize_int8(x)
    err = torch.max(torch.abs(dequantize_int8(q, scale) - x))
    assert float(err) <= float(scale) / 2 + 1e-6


def test_error_feedback_accumulates():
    grads = {"w": torch.full((16,), 0.001)}
    deq, scales, resid = quantize_tree(grads, None)
    # residual + dequantised == original
    np.testing.assert_allclose(
        deq["w"].numpy().astype(np.float64) + resid["w"].numpy(),
        grads["w"].numpy().astype(np.float64), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 7, 4096, 65536])
def test_feedback_unbiased_over_steps(seed):
    # With constant gradients, error feedback makes the *cumulative*
    # applied update converge to the true cumulative gradient.
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.normal(size=(32,)) * 1e-3).astype(np.float32))
    applied = torch.zeros_like(g)
    resid = None
    steps = 50
    for _ in range(steps):
        deq, _, resid = quantize_tree({"g": g}, resid)
        applied = applied + deq["g"]
    np.testing.assert_allclose(applied.numpy() / steps, g.numpy(), atol=2e-5)


def test_compress_grads_is_declared_and_never_read():
    import inspect

    from repro_torch.runtime import trainer

    assert trainer.TrainConfig().compress_grads is False
    src = inspect.getsource(trainer)
    assert src.count("compress_grads") == 1
