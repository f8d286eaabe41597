"""The port's cost counter (``launch/graph_analysis.py``, the counterpart
of the reference's ``launch/hlo_analysis.py``) on the cases of
``tests/test_hlo_analysis.py``: exact matmul flops, a batched dot, a
layer loop counted once per trip (8x) and nested loops (3 x 5 = 15x), a
stacked weight billed per slice (above the ideal, far below the full
stack), an elementwise op billed at least its read and write, no
collective on one device and an all-reduce counted with its bytes. Then
the port's own rules: a hand-written kernel's plain version billed as the
kernel, a gather billed by its rows, and per-device counts of a sharded
program on the production mesh.
"""

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.graph_analysis import (
    COLLECTIVE_OPS,
    CostCounter,
    collective_bytes,
    count,
    graph_metrics,
)

torch.set_num_threads(1)


def _zeros(*shape):
    return torch.zeros(shape, device="meta")


def layer_loop(x, ws):
    h = x
    for w in ws:          # a view of the stacked weight per trip
        h = h @ w
    return h


# -- the cases of tests/test_hlo_analysis.py ---------------------------------


def test_plain_matmul_exact():
    m = graph_metrics(lambda a, b: a @ b, _zeros(1024, 512), _zeros(512, 256))
    assert m["flops"] == 2 * 1024 * 512 * 256


def test_loop_multiplies_by_trip_count():
    m = graph_metrics(layer_loop, _zeros(512, 256), _zeros(8, 256, 256))
    assert m["flops"] == 8 * 2 * 512 * 256 * 256


def test_batched_dot():
    m = graph_metrics(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                      _zeros(4, 128, 64), _zeros(4, 64, 32))
    assert m["flops"] == 2 * 4 * 128 * 64 * 32


def test_nested_loop_trips_compose():
    def outer(x, ws2):
        h = x
        for ws in ws2:
            h = layer_loop(h, ws)
        return h

    m = graph_metrics(outer, _zeros(64, 64), _zeros(3, 5, 64, 64))
    assert m["flops"] == 15 * 2 * 64 ** 3


def test_loop_weight_slicing_not_billed_full():
    # the stacked [8, 256, 256] weights are billed per slice inside the
    # loop, not 8x the full stack
    m = graph_metrics(layer_loop, _zeros(512, 256), _zeros(8, 256, 256))
    ideal = 8 * 256 * 256 * 4 + 9 * 512 * 256 * 4
    assert m["bytes"] < 8 * ideal
    assert m["bytes"] > ideal       # and a true upper bound
    # each trip reads h and its slice and writes h
    assert m["bytes"] == 8 * (2 * 512 * 256 + 256 * 256) * 4


def test_memory_bound_op_dominates():
    x = torch.zeros(4096, 4096)
    m = graph_metrics(lambda x: x * 2.0 + 1.0, x)
    assert m["bytes"] >= 2 * x.nbytes  # read + write at least
    assert m["flops"] == 0.0


def test_no_collectives_single_device():
    cb = collective_bytes(lambda x: x @ x, torch.zeros(64, 64))
    assert cb["bytes"]["total"] == 0.0
    assert set(cb["bytes"]) == set(COLLECTIVE_OPS) | {"total"}


def test_all_reduce_counted():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        def f(x):
            y = x.clone()
            dist.all_reduce(y)
            return y

        cb = collective_bytes(f, torch.zeros(8, 128))
        assert cb["bytes"]["all-reduce"] == 8 * 128 * 4
        assert cb["bytes"]["total"] == 8 * 128 * 4
        assert cb["counts"]["all-reduce"] == 1
    finally:
        dist.destroy_process_group()


# -- the port's own rules -----------------------------------------------------


def test_kernel_plain_version_billed_as_the_kernel():
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    x, g = _zeros(1024, 4096), _zeros(4096)
    _, c = count(rmsnorm, x, g)
    # one read of x and of the gain, one write of the output (the plain
    # version's float32 casts, mean and rsqrt bill nothing more)
    assert c.bytes == (2 * 1024 * 4096 + 4096) * 4


def test_attention_kernel_keeps_its_flops():
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k = _zeros(2, 4, 64, 32), _zeros(2, 2, 64, 32)
    _, c = count(flash_attention, q, k, k, causal=True)
    assert c.flops >= 2 * 2 * (2 * 4 * 64 * 64 * 32)  # QK^T and PV
    assert c.bytes == (q.numel() * 2 + k.numel() * 2) * 4


def test_gather_billed_by_its_rows():
    table = _zeros(151936, 4096)
    tokens = torch.zeros(8, 128, dtype=torch.int64, device="meta")
    m = graph_metrics(lambda t, i: t[i], table, tokens)
    rows = 8 * 128 * 4096 * 4
    assert m["bytes"] == 2 * rows + tokens.numel() * 8


def test_peak_bytes_of_live_outputs():
    with CostCounter() as c:
        a = _zeros(1024, 1024) + 1.0
        b = a * 2.0
        del a, b
        d = _zeros(10) + 1.0
    assert c.peak_bytes == 2 * 1024 * 1024 * 4
    assert c.live_bytes == d.numel() * 4


@pytest.fixture
def production_mesh():
    from repro_torch.launch.mesh import make_production_mesh, release_mesh

    release_mesh()
    yield make_production_mesh()
    release_mesh()


def test_sharded_matmul_counts_per_device(production_mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import NamedSharding

    mesh = production_mesh
    n, d, f = 4096, 1024, 2048
    x = NamedSharding(mesh, ("data", None)).shard_meta(_zeros(n, d))
    w = NamedSharding(mesh, ("data", "model")).shard_meta(_zeros(d, f))
    assert x.placements == (Shard(0), Replicate())
    y, c = count(lambda: x @ w)
    # the FSDP weight is gathered over "data", then each device multiplies
    # its rows by its columns
    assert c.flops == 2 * (n // 16) * d * (f // 16)
    assert c.coll_counts["all-gather"] == 1
    assert c.coll_bytes["all-gather"] == d * (f // 16) * 4
    assert tuple(y.to_local().shape) == (n // 16, f // 16)


def _ref_scan(x, ws):
    import jax

    def body(h, w):
        return h @ w, None
    return jax.lax.scan(body, x, ws)[0]


@pytest.mark.parametrize("case", ["matmul", "batched", "scan"])
def test_flops_equal_the_references_hlo_metrics(case):
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import hlo_metrics

    shapes = {"matmul": ((1024, 512), (512, 256)),
              "batched": ((4, 128, 64), (4, 64, 32)),
              "scan": ((512, 256), (8, 256, 256))}[case]
    ref_fn = {"matmul": lambda a, b: a @ b,
              "batched": lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
              "scan": _ref_scan}[case]
    port_fn = {"matmul": lambda a, b: a @ b,
               "batched": lambda a, b: torch.einsum("bij,bjk->bik", a, b),
               "scan": layer_loop}[case]
    text = jax.jit(ref_fn).lower(*(jnp.zeros(s) for s in shapes)).compile(
        ).as_text()
    want = hlo_metrics(text)["flops"]
    assert graph_metrics(port_fn, *(_zeros(*s) for s in shapes))[
        "flops"] == want


# -- a sharded program partitioned as XLA partitions it ----------------------


def _count_as_xla(fn):
    """``count(fn)`` as the dry-run counts (``CostCounter(as_xla=True)``)."""
    with CostCounter(as_xla=True) as c:
        out = fn()
    return out, c


def _shard(mesh, spec, *shape, dtype=torch.float32):
    from repro_torch.distributed.sharding import NamedSharding

    return NamedSharding(mesh, spec).shard_meta(
        torch.zeros(shape, dtype=dtype, device="meta"))


def test_embedding_gather_keeps_the_batch_sharding(production_mesh):
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_mesh
    # the serve rules' table: vocab over "model", embed whole
    table = _shard(mesh, ("model", None), 4096, 1024)
    tokens = _shard(mesh, ("data", None), 256, 64, dtype=torch.int64)
    out, c = count(lambda: table[tokens])
    assert out.placements == (Shard(0), Replicate())
    assert tuple(out.to_local().shape) == (256 // 16, 64, 1024)
    assert c.flops == 0
    # the rows are looked up where they lie: the table is not gathered
    assert sum(c.coll_bytes.values()) < 4096 * 1024 * 4


def test_fsdp_table_lookup_replicates_the_rows(production_mesh):
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_mesh
    # the train rules' table: vocab over "model", embed over "data"; XLA
    # keeps it in place and gathers the indices, so every device of
    # "data" looks up every row for its slice of the embedding
    table = _shard(mesh, ("model", "data"), 4096, 1024)
    tokens = _shard(mesh, ("data", None), 256, 64, dtype=torch.int64)
    out, c = count(lambda: table[tokens])
    assert out.placements == (Shard(2), Replicate())
    assert tuple(out.to_local().shape) == (256, 64, 1024 // 16)
    assert c.flops == 0
    # the indices are gathered, the table is not
    assert sum(c.coll_bytes.values()) < 4096 * 1024 * 4


@pytest.mark.parametrize("log", [False, True])
def test_softmax_over_a_sharded_dimension(production_mesh, log):
    mesh = production_mesh
    x = _shard(mesh, ("data", "model"), 64, 4096)
    fn = torch.log_softmax if log else torch.softmax
    y, c = count(lambda: fn(x, dim=-1))
    assert y.placements == x.placements
    # the row max and the row sum, each all-reduced over "model"
    assert c.coll_counts["all-reduce"] == 2
    assert c.coll_bytes["all-reduce"] == 2 * (64 // 16) * 4
    assert c.coll_counts["all-gather"] == 0


def test_cache_write_stays_in_its_shard(production_mesh):
    mesh = production_mesh
    cache = _shard(mesh, ("data", "model", None, None), 16, 4096, 8, 128)
    new = _shard(mesh, ("data", None, None, None), 16, 1, 8, 128)
    pos = torch.zeros(1, dtype=torch.int64, device="meta")
    placements = cache.placements
    _, c = count(lambda: cache.index_copy_(1, pos, new))
    assert cache.placements == placements
    assert sum(c.coll_counts.values()) == 0


def test_a_partial_sum_is_reduced_once(production_mesh):
    mesh = production_mesh
    n, d, f = 1024, 512, 256
    x = _shard(mesh, ("data", "model"), n, d)
    w = _shard(mesh, ("model", None), d, f)

    def step():
        y = x @ w            # row-parallel: a partial sum over "model"
        return y * y + y     # read three times, reduced once

    _, c = count(step)
    assert c.coll_counts["all-reduce"] == 1
    assert c.coll_bytes["all-reduce"] == (n // 16) * f * 4
    assert c.flops == 2 * (n // 16) * (d // 16) * f + 0


def test_attention_heads_split_past_the_kv_heads(production_mesh):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    mesh = production_mesh
    b, h, kh, s, d = 16, 32, 8, 64, 32
    q = _shard(mesh, ("data", "model", None, None), b, h, s, d)
    # 8 kv heads do not split 16 ways: they stay whole on "model"
    k = _shard(mesh, ("data", None, None, None), b, kh, s, d)
    out, c = count(flash_attention, q, k, k, causal=True)
    assert out.placements == q.placements
    assert c.flops == 2 * 2 * (b // 16) * (h // 16) * s * s * d
    assert sum(c.coll_counts.values()) == 0


def test_attention_backward_on_shards(production_mesh):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    mesh = production_mesh
    b, h, kh, s, d = 16, 32, 8, 64, 32
    q = _shard(mesh, ("data", "model", None, None), b, h, s, d)
    k = _shard(mesh, ("data", None, None, None), b, kh, s, d)
    v = _shard(mesh, ("data", None, None, None), b, kh, s, d)
    for t in (q, k, v):
        t.requires_grad_(True)

    def step():
        out = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    fwd = 2 * 2 * (b // 16) * (h // 16) * s * s * d
    (dq, dk, dv), c = _count_as_xla(step)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    assert dq.placements == q.placements
    # XLA's autodiff of the reference's attention: dP, dq, dk and dv; the
    # kernel's recompute of P is not billed (XLA keeps P)
    assert c.flops == fwd + 2 * fwd
    # any other count bills the kernel's own backward on the shards: the
    # recompute of P, then dP, dq, dk and dv
    (dq, dk, dv), c = count(step)
    assert dq.placements == q.placements
    assert c.flops == fwd + 5 * fwd // 2


def test_attention_backward_on_every_row_splits_dv(production_mesh):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    mesh = production_mesh
    b, h, kh, s, d = 16, 32, 8, 64, 32
    # every batch row on each device (the train rules' lookup)
    q = _shard(mesh, (None, "model", None, None), b, h, s, d)
    k = _shard(mesh, (None, None, None, None), b, kh, s, d)
    v = _shard(mesh, (None, None, None, None), b, kh, s, d)
    for t in (q, k, v):
        t.requires_grad_(True)

    def step():
        out = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    (dq, dk, dv), c = _count_as_xla(step)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    fwd = 2 * 2 * b * (h // 16) * s * s * d
    # dP, dq and dk whole, and dv on half its columns: the two devices of
    # "model" that share a kv head split its dv, as XLA does
    assert c.flops == fwd + 3 * fwd // 2 + fwd // 4


def test_lookup_backward_adds_rows_into_a_partial_table(production_mesh):
    mesh = production_mesh
    table = _shard(mesh, ("model", None), 4096, 1024).requires_grad_(True)
    tokens = _shard(mesh, ("data", None), 256, 64, dtype=torch.int64)

    def step():
        out = table[tokens]
        return torch.autograd.grad(out, table, torch.ones_like(out))[0]

    grad, c = count(step)
    assert grad.shape == table.shape
    # each device adds its own rows: a partial table over "data", whole
    # on "model"; no gradient row is gathered
    assert grad.placements[0].is_partial()
    assert tuple(grad.to_local().shape) == (4096, 1024)
    assert sum(c.coll_bytes.values()) < 4096 * 1024 * 4


def test_fsdp_lookup_backward_adds_rows_into_each_slice(production_mesh):
    from torch.distributed.tensor import Shard

    mesh = production_mesh
    table = _shard(mesh, ("model", "data"), 4096, 1024).requires_grad_(True)
    tokens = _shard(mesh, ("data", None), 256, 64, dtype=torch.int64)

    def step():
        out = table[tokens]
        return torch.autograd.grad(out, table, torch.ones_like(out))[0]

    grad, c = count(step)
    assert grad.shape == table.shape
    # every row into each device's slice of the embedding: no partial
    # sum, and no gradient row gathered (the forward's lookup sums its
    # vocab-masked rows over "model", no more)
    assert grad.placements[0] == Shard(1)
    assert tuple(grad.to_local().shape) == (4096, 1024 // 16)
    assert sum(c.coll_bytes.values()) < 4096 * 1024 * 4


def test_elementwise_op_on_alike_shards(production_mesh):
    mesh = production_mesh
    ang = _shard(mesh, ("data", "model"), 64, 64)
    out, c = count(lambda: torch.polar(torch.ones_like(ang), ang))
    assert out.placements == ang.placements and out.dtype == torch.complex64
    assert tuple(out.to_local().shape) == (4, 4)
    assert sum(c.coll_counts.values()) == 0


def test_an_op_without_a_sharding_rule_raises(production_mesh):
    # no replicated stand-in: the dry-run writes the cell's error record
    x = _shard(production_mesh, ("data", None), 64, 64)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        count(lambda: torch.renorm(x, 2, 0, 1.0))


def test_outer_product_bills_no_flops(production_mesh):
    # a contraction of size 1 is a multiply to XLA's simplifier: no dot
    mesh = production_mesh
    a = _shard(mesh, ("data", None), 64, 1)
    b = _shard(mesh, (None, None), 1, 32)
    assert _count_as_xla(lambda: a @ b)[1].flops == 0
    a = _shard(mesh, ("data", None, None), 16, 64, 1)
    b = _shard(mesh, ("data", None, None), 16, 1, 32)
    assert _count_as_xla(lambda: torch.bmm(a, b))[1].flops == 0
    # any other count bills the product the port launches for it
    assert count(lambda: torch.bmm(a, b))[1].flops == 2 * 64 * 32


def test_plain_count_bills_an_outer_product():
    # on one card the port launches a product for it all the same
    m = graph_metrics(lambda a, b: a @ b, _zeros(64, 1), _zeros(1, 32))
    assert m["flops"] == 2 * 64 * 32
    m = graph_metrics(torch.bmm, _zeros(4, 64, 1), _zeros(4, 1, 32))
    assert m["flops"] == 2 * 4 * 64 * 32


@pytest.mark.parametrize("kh", [32, 8])
def test_plain_attention_backward_bills_the_kernels_products(kh):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    b, h, s, d = 2, 32, 64, 32
    q = _zeros(b, h, s, d).requires_grad_(True)
    k = _zeros(b, kh, s, d).requires_grad_(True)
    v = _zeros(b, kh, s, d).requires_grad_(True)

    def step():
        out = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    (dq, dk, dv), c = count(step)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    fwd = 2 * 2 * b * h * s * s * d
    # one card: the kernel's own backward, which recomputes P, then dP,
    # dq, dk and dv
    assert c.flops == fwd + 5 * fwd // 2


def test_split_along_a_sharded_dimension_keeps_it(production_mesh):
    mesh = production_mesh
    x = _shard(mesh, ("data", "model"), 256, 2048).requires_grad_(True)

    def step():
        a, b = x.chunk(2, dim=-1)
        return a, b, torch.autograd.grad((a * b).sum(), x)[0]

    (a, b, grad), c = count(step)
    # each piece keeps "model" on its columns, and so does the gradient
    # (the pieces' gradients concatenated)
    assert a.placements == b.placements == x.placements
    assert tuple(a.to_local().shape) == (256 // 16, 1024 // 16)
    assert grad.placements == x.placements
    assert c.flops == 0


def test_cross_entropy_gradient_keeps_the_logits_sharding(production_mesh):
    from repro_torch.models.common import cross_entropy

    mesh = production_mesh
    # the train rules' logits: every row on each device, the vocabulary
    # over "model"; labels sharded on the batch
    logits = _shard(mesh, (None, None, "model"), 16, 8, 4096)
    logits.requires_grad_(True)
    labels = _shard(mesh, ("data", None), 16, 8, dtype=torch.int64)

    def step():
        loss = cross_entropy(logits, labels)
        return loss, torch.autograd.grad(loss, logits)[0]

    (loss, grad), c = count(step)
    assert loss.shape == ()
    assert grad.placements == logits.placements
    assert tuple(grad.to_local().shape) == (16, 8, 4096 // 16)
    # each row's max, sum and label logit reduced, no logit row gathered
    assert sum(c.coll_bytes.values()) < 16 * 8 * 4096 * 4 // 16


@pytest.mark.parametrize("rows", [1, 32])
def test_decode_attention_splits_the_keys(production_mesh, rows):
    """The decode-attention kernel over the serve rules' placements: q's
    heads and the cache's positions both on "model". Each device scores
    every head on its 1/16 of the positions. With one row, "data" is idle
    and the value product runs on the device's 2 of 32 heads there (kv
    heads over 8, the group over 2), then its output moves back onto
    "model" by one collective-permute; with the rows on "data", on every
    head, the output whole on each device of "model"."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.decode_attention.ops import decode_attention

    mesh = production_mesh
    h, kh, s, d = 32, 8, 32768, 128
    b = "data" if rows > 1 else None   # one row is not split
    q = _shard(mesh, (b, "model", None), rows, h, d)
    k = _shard(mesh, (b, None, "model", None), rows, kh, s, d)
    lengths = _shard(mesh, (b,), rows, dtype=torch.int32)
    out, c = count(decode_attention, q, k, k, lengths)
    local = rows // 16 if rows > 1 else 1
    scores = 2 * local * h * (s // 16) * d
    values = scores // 16 if rows == 1 else scores
    assert c.flops == scores + values
    assert out.shape == (rows, h, d)
    # the positions' partial sums all-reduced over "model"; one row's
    # heads moved back there
    assert out.placements == ((Shard(0), Replicate()) if rows > 1
                              else (Replicate(), Shard(1)))
    assert c.coll_counts["collective-permute"] == (1 if rows == 1 else 0)


def test_plain_count_bills_the_decode_products_over_the_whole_cache():
    """With no mesh, the plain count (no ``as_xla``, as the roofline
    counts) bills one ``decode_step`` of a two-layer model with the decode
    kernel's own two products, scores and values, over every head and the
    whole cache: the only products whose size follows the cache's length,
    so two lengths' counts part by exactly those."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              exits=(1, 2))
    model = build_model(cfg, device="meta")
    token = torch.zeros(4, 1, dtype=torch.int32, device="meta")
    flops = {}
    for s in (1024, 4096):
        cache = model.init_cache(4, s, 1)
        flops[s] = count(model.decode_step, token, cache, 1)[1].flops
    per_position = 2 * 4 * cfg.num_heads * cfg.head_dim
    assert flops[4096] - flops[1024] == (cfg.num_layers * 2 * per_position
                                         * (4096 - 1024))
