"""Cost accounting of the port's own programs: flops, bytes and collective
traffic per device, the counterpart of ``src/repro/launch/hlo_analysis.py``.

The reference lowers a step to XLA and reads the optimised HLO text: dot
flops, every top-level instruction's operand and result bytes, and the
result bytes of every collective, each multiplied through the while-loop
call graph by its ``known_trip_count``. The port has no HLO; it runs the
step eagerly (on ``meta`` tensors for a shape-only count) under
``CostCounter``, a torch dispatch mode that sees every aten op that
reaches a kernel and bills it by the same rules:

* **flops**: ``torch.utils.flop_counter``'s per-op formulas (matmuls,
  convolutions, attention); elementwise work is not counted, as the
  reference counts dots only; in the dry-run's count (``as_xla``, set by
  ``launch/dryrun.py::lower_cell``) neither is a product that contracts a
  dimension of size 1 (an outer product, which XLA's simplifier turns into
  a multiply; the port launches a product for it, which any other count
  bills).
* **bytes**: each op's tensor inputs and its fresh outputs at their own
  sizes: eager torch runs each op as its own kernel, which moves just that.
  A hand-written kernel's wrapper, which takes its plain version on
  ``meta`` and CPU tensors, is billed as the kernel: one fused op whose
  inputs are read once and outputs written once (the plain version's flops
  are kept, but in the dry-run's count the attention backward's: see
  below), as XLA bills a fusion by its operands and results. Views
  (``select``, ``slice``, ``transpose``, ``expand``, ...) move nothing and
  bill nothing, so a layer's view of a stacked weight is billed
  as the slice its consumer reads, the reference's "a sliced weight is not
  billed in full". An in-place op bills its written input as read and
  written (``copy_``/``fill_``/``zero_`` as written only). A gather
  (``index``, ``index_select``, ``embedding``, ``gather``) reads the rows it
  writes, not its whole source, as the reference bills a ``dynamic-slice``
  by its result: an embedding lookup is not billed the whole table. A small tensor
  that stays in L2 between two ops is billed twice all the same.
* **collectives**: the result bytes of every ``c10d`` / ``c10d_functional``
  collective (all-gather, all-reduce, reduce-scatter, all-to-all, and
  broadcast / send / recv as collective-permute), which
  ``torch.distributed.tensor.debug.CommDebugMode`` counts but does not
  size.
* **loops**: an eager Python loop over a handful of trips (layers,
  chunks, experts) runs its body once per trip, and every trip dispatches
  its ops again, so those are billed trip by trip. A time loop over the
  tokens (``models/mamba.py::_selective_scan``,
  ``models/rwkv6.py::_wkv_scan``) asks ``kernels/checks.py::time_loop``
  for its trips: under a counter it runs one trip, which :meth:`trips`
  bills S times, the reference's ``known_trip_count`` weighting of a
  ``lax.scan`` body (``src/repro/launch/hlo_analysis.py``), and returns
  that trip's output broadcast over the S steps (the right shapes and
  placements, not the values); the trip's backward is billed S times
  too. Outside a counter the loop runs every trip. The dry-run builds a
  config of remat ``"dots"`` with ``"none"`` (``launch/dryrun.py::
  lower_cell``): XLA's policy keeps every product, so its backward
  recomputes none, where the port's checkpoint recomputes the block.

Over ``DTensor``s (a sharded program on a ``DeviceMesh``) the mode lets
each ``DTensor`` op run its sharding rule and counts the local ops and the
collectives it issues: the numbers are this rank's, per device, as the
reference's are of the SPMD-partitioned program. ``DTensor`` picks each
op's placements by the cheapest redistribution alone. Where that is not
what XLA's partitioner does with the reference's program (which would
count work that XLA does not do, or miss work it does), the counter
partitions as XLA does, by these rules; each was found by comparing the
two programs op by op (``tools/dryrun_diff.py``), and they are not a
general model of XLA's sharding propagation:

* a partial sum is reduced once, at its first reader, all-reduced (or,
  for a gradient, reduce-scattered onto its parameter's sharding), not
  carried into the next product, which every device would compute whole;
* a lookup (``table[rows]``) of a table sharded on its embedding over the
  mesh dimensions that shard the rows (the train rules' FSDP) keeps the
  table in place and gathers the indices, so that the step runs on every
  batch row with the embedding split (:func:`_lookup`); on the other
  dimensions the table is gathered and each device looks up its own rows;
  a vocab-sharded table is looked up where its rows lie. Its backward adds
  every row into each device's slice of the embedding, or, where the rows
  are split, each device's rows into a partial table (:func:`_rows_added`);
* a softmax along a sharded dimension all-reduces its row max and sum,
  and so does the cross-entropy over vocab-sharded logits, which runs on
  the logits' own shards (:func:`_cross_entropy_partition`); a row
  written into a sharded dimension (a decode step's cache) is written
  into its shard;
* the flash-attention kernel runs on each device's batch rows and query
  heads with the kv heads they read, also where a mesh dimension splits
  the query heads but not the kv heads; in the dry-run's count its
  backward is billed as XLA's autodiff of the reference's attention
  computes it: four products, no recompute of the probabilities, dv on a
  share of its columns where devices share a kv head
  (:func:`_attention_bwd_as_xla`), elsewhere as the kernel's own; the RMSNorm
  backward takes each gradient on its input's sharding;
* the decode-attention kernel runs on each device's batch rows and, where
  a mesh dimension splits the cache's positions, on its positions for
  every head, the softmax's max and sum and the output's partial sums
  all-reduced over that dimension; where q's heads lay there and a mesh
  dimension of the same size is idle (one row), the value product on each
  device's own heads over the idle dimension, the output moved back by one
  collective-permute (:func:`_local_decode_attention`);
* MLA attention (``models/attention.py::_mla_attend``) runs with its
  heads on the mesh dimension that shards them, or, where a decode cache
  shards the keys' positions, split on those positions
  (:func:`_mla_partition`); the WKV recurrence on each device's rows and
  heads (:func:`_wkv_partition`); the MoE's routed experts on each
  device's experts (:func:`_moe_partition`); cross-attention on the
  encoder's rows (:func:`_cross_partition`); the unembedding of a
  vocabulary that does not divide the axis, in a train step, as XLA splits
  it (:func:`_unembed_partition`): each on local shards, forward and
  backward, so that no ``DTensor`` choice, which differs between torch
  versions, enters its count;
* a layer loop's hidden state keeps one sharding from block to block
  (:func:`_layer_partition`), as XLA's scan over the layers keeps its
  carry's;
* a reshape that ``DTensor`` cannot shard (a dimension split 16 ways cut
  into 8 heads) gathers the dimensions it reshapes, and its gradient takes
  the source's sharding again on the way back, as XLA keeps the tiling; a
  split or a concatenation along a sharded dimension keeps that sharding
  on each part.

The products these rules do not cover (the projections, the MLPs) are
left to ``DTensor``'s choices; the test files below hold their counts too.
Two of RWKV6's, the channel mix's receptance and the weight gradient of
the time mix's ``w_o``, XLA splits by no rule of their parameters' specs;
the counter splits them otherwise, and ``_train.py`` holds both counts
phase by phase. SmolLM's q projection on (2, 16, 16): XLA takes its input
gradient over all the query columns on each device of "model", where on
(16, 16), and for the k and v projections on both meshes, it keeps the
gradient's tiling as the counter does; ``_train.py`` holds that one
product's difference.
An op with no sharding rule raises: the dry-run writes the cell's
``"error"`` record, never a count of the op run replicated.
``tests/test_torch_dryrun_reference.py``, ``_zoo.py`` and ``_train.py``
hold the result against the reference's ``lower_cell`` on depth-cut
cells.

``CostCounter.peak_bytes`` is the peak of the bytes held by the op outputs
still alive during the run (arguments excluded), the counterpart of
``memory_analysis``'s temporaries.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import checks

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op-name fragments of the c10d / c10d_functional collectives
_COLLECTIVE_NAMES = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("broadcast", "collective-permute"), ("send", "collective-permute"),
    ("recv", "collective-permute"), ("permute", "collective-permute"),
)
_COLLECTIVE_NAMESPACES = ("c10d", "c10d_functional", "_c10d_functional")

_aten = torch.ops.aten
# ops that move no data: shape queries, allocation without a write
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.lift_fresh.default, _aten.sym_size.int, _aten.sym_stride.int,
    _aten.sym_numel.default, _aten.sym_storage_offset.default,
    _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.stride.default, _aten.storage_offset.default,
    _aten.numel.default, _aten.dim.default, torch.ops.prim.layout.default,
    _aten._unsafe_view.default,   # a reshape's view, not marked as one
}
# bookkeeping ops of the functional collectives (registered with them)
_FREE_NAMES = ("_c10d_functional::wait_tensor",
               "_c10d_functional::_wrap_tensor_autograd",
               "c10d_functional::wait_tensor")
# reshapes that DTensor may refuse to shard (see CostCounter._reshape)
_RESHAPES = {_aten.view.default, _aten._unsafe_view.default}
# gathers: the source is read where the output is written
_GATHERS = {_aten.index.Tensor, _aten.index_select.default,
            _aten.embedding.default, _aten.gather.default}
# in-place ops that overwrite their output without reading it
_WRITE_ONLY = ("copy_", "fill_", "zero_", "normal_", "uniform_")


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` on this device (a ``DTensor``'s local shard)."""
    t = getattr(t, "_local_tensor", t)
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


# matrix products by the argument that holds the contraction as its last
# dimension
_PRODUCTS = {_aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1}


def _outer_product(packet, args) -> bool:
    """Whether a matrix product contracts a dimension of size 1: an outer
    product, which XLA's simplifier turns into a multiply (no dot, so no
    flops in the reference's count; the backward of a product with a
    vector, say). Only a count ``as_xla`` takes it so: the port launches a
    product for it all the same."""
    at = _PRODUCTS.get(packet)
    return (at is not None and len(args) > at
            and isinstance(args[at], torch.Tensor)
            and args[at].shape[-1] == 1)


def _collective_kind(func) -> str:
    ns = func.namespace
    if ns not in _COLLECTIVE_NAMESPACES:
        return ""
    name = func._schema.name.split("::")[-1]
    for frag, kind in _COLLECTIVE_NAMES:
        if frag in name:
            return kind
    return ""


# Where XLA's partitioner keeps a sharded operand in place and ``DTensor``'s
# rule would gather it whole, the counter runs XLA's partition: each takes
# the op's ``DTensor`` arguments and returns its ``DTensor`` result, or
# ``NotImplemented`` to leave the op to ``DTensor``.

def _sharded_on(x, dim):
    """Mesh dimensions that shard ``x``'s dimension ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def _like(t, mesh, placements):
    """``t``'s local shard under ``placements`` (a plain tensor counts as
    replicated, as ``implicit_replication`` has it)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local()


def _lookup(table, rows, *rest):
    """``embedding(table, rows)`` partitioned as XLA partitions a lookup,
    mesh dimension by mesh dimension. Where a dimension shards the rows'
    indices and the table's embedding dimension (an FSDP-sharded table
    under the train rules), XLA keeps the table in place and gathers the
    indices: every device of that dimension looks up every row, for its
    own slice of the embedding, so the output loses its batch sharding
    there (the reference's ``train_rules_pure_dp`` records this). Where a
    dimension shards the rows but not the table's embedding, the table is
    gathered and each device looks up its own rows, so the output keeps
    the batch sharding. A vocab-sharded table is looked up where its rows
    lie, and the masked rows summed over the shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(table, DTensor) and isinstance(rows, DTensor):
        t_at, r_at = list(table.placements), list(rows.placements)
        for i, r in enumerate(r_at):
            if not isinstance(r, Shard):
                continue
            if t_at[i] == Shard(1):
                r_at[i] = Replicate()
            else:
                t_at[i] = Replicate()
        table = table.redistribute(table.device_mesh, t_at)
        rows = rows.redistribute(rows.device_mesh, r_at)
    out = _aten.embedding.default(table, rows, *rest)
    if isinstance(out, DTensor) and any(p.is_partial()
                                        for p in out.placements):
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def _index_as_embedding(src, indices):
    """``table[rows]`` of a 2-D table is ``embedding(table, rows)``: a
    lookup (:func:`_lookup`), where ``index``'s rule gathers the table."""
    if (src.ndim != 2 or len(indices) != 1 or indices[0] is None
            or indices[0].dtype not in (torch.int32, torch.int64)):
        return NotImplemented
    return _lookup(src, indices[0])


def _softmax_parts(x, dim, log):
    """Softmax or log-softmax of ``x`` along a sharded ``dim``: the local
    max and sum all-reduced over the shards, the result sharded as ``x``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    dim = dim % x.ndim
    over = _sharded_on(x, dim)
    if not over or any(p.is_partial() for p in x.placements):
        return NotImplemented
    mesh, local = x.device_mesh, x._local_tensor
    m = local.amax(dim, keepdim=True)
    for i in over:
        m = funcol.all_reduce(m, "max", (mesh, i))
    shifted = local - m
    s = torch.exp(shifted).sum(dim, keepdim=True)
    for i in over:
        s = funcol.all_reduce(s, "sum", (mesh, i))
    out = shifted - torch.log(s) if log else torch.exp(shifted) / s
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def _softmax_bwd_parts(grad, out, dim, log):
    """The backward of :func:`_softmax_parts`: its one sum all-reduced."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor

    dim = dim % out.ndim
    over = _sharded_on(out, dim)
    if not over or any(p.is_partial() for p in out.placements):
        return NotImplemented
    mesh, y = out.device_mesh, out._local_tensor
    g = _like(grad, mesh, out.placements)
    s = (g if log else g * y).sum(dim, keepdim=True)
    for i in over:
        s = funcol.all_reduce(s, "sum", (mesh, i))
    dx = g - torch.exp(y) * s if log else y * (g - s)
    return DTensor.from_local(dx, mesh, out.placements, run_check=False)


def _index_copy_in_place(dest, dim, index, source):
    """A row written into a sharded dimension (a decode step's cache
    write) is written into the shard that holds it, as XLA's
    dynamic-update-slice is, where ``DTensor`` gathers the whole cache."""
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % dest.ndim
    if (not _sharded_on(dest, dim)
            or any(p.is_partial() for p in dest.placements)):
        return NotImplemented
    mesh = dest.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim != dim else Replicate()
            for p in dest.placements]
    _aten.index_copy_.default(
        dest._local_tensor, dim,
        _like(index, mesh, [Replicate()] * mesh.ndim),
        _like(source, mesh, rows))
    return dest


def _rows_added(table, indices, values, accumulate=False):
    """Rows added into a table (``table[rows] += values``: a lookup's
    backward, the gradient rows into a zero table), as XLA partitions a
    scatter-add, mesh dimension by mesh dimension: where the rows are
    sharded, each device adds its own rows into a whole table, which is
    then a partial sum; where the values' embedding is sharded (the train
    rules' lookup, :func:`_lookup`), each device adds every row into its
    own slice of the table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if (not accumulate or len(indices) != 1 or indices[0] is None
            or not isinstance(table, DTensor)):
        return NotImplemented
    mesh, rows = table.device_mesh, indices[0]
    split = (list(rows.placements) if isinstance(rows, DTensor)
             else [Replicate()] * mesh.ndim)
    if any(p.is_partial() for p in split):
        return NotImplemented
    last = Shard(values.ndim - 1)
    t_at, r_at, v_at, out_at = [], [], [], []
    for i, r in enumerate(split):
        if (table.ndim == 2 and isinstance(values, DTensor)
                and values.placements[i] == last):
            at = (Shard(1), Replicate(), last, Shard(1))
        elif isinstance(r, Shard):
            at = (Replicate(), r, r, Partial())
        else:
            at = (Replicate(), Replicate(), Replicate(), Replicate())
        for acc, p in zip((t_at, r_at, v_at, out_at), at):
            acc.append(p)
    out = _aten.index_put.default(
        _like(table, mesh, t_at), [_like(rows, mesh, r_at)],
        _like(values, mesh, v_at), True)
    return DTensor.from_local(out, mesh, out_at, run_check=False)


def _pieces_sharded(x, dim, sizes):
    """The mesh dimensions that shard ``x``'s ``dim``, where each piece of
    ``sizes`` along it divides among them (else None)."""
    over = _sharded_on(x, dim)
    if not over or any(p.is_partial() for p in x.placements):
        return None
    ways = 1
    for i in over:
        ways *= x.device_mesh.size(i)
    return over if all(n % ways == 0 for n in sizes) else None


def _split_sharded(x, split, dim=0):
    """A split along a sharded dimension (a fused projection cut into its
    parts: Mamba's x and z) into pieces that each divide among the shards:
    every piece keeps the sharding, as XLA reshards the parts onto the
    devices (here billed as the gather ``DTensor`` makes and a local
    slice of each piece), where ``DTensor`` leaves them whole on every
    device."""
    from torch.distributed.tensor import Replicate

    dim = dim % x.ndim
    size = x.shape[dim]
    sizes = (list(split) if isinstance(split, (list, tuple))
             else [min(split, size - i) for i in range(0, size, split)])
    over = _pieces_sharded(x, dim, sizes)
    if over is None:
        return NotImplemented
    mesh, placements = x.device_mesh, x.placements
    whole = x.redistribute(mesh, [Replicate() if i in over else p
                                  for i, p in enumerate(placements)])
    return [t.redistribute(mesh, placements)
            for t in _aten.split_with_sizes.default(whole, sizes, dim)]


def _cat_sharded(tensors, dim=0):
    """A concatenation along a dimension that shards every part alike (a
    split's backward, the gradients of its pieces): the result keeps the
    sharding, as XLA's does (billed as a gather of the parts and a local
    slice), where ``DTensor`` leaves it whole on every device."""
    from torch.distributed.tensor import DTensor, Replicate

    if len(tensors) < 2 or not all(isinstance(t, DTensor) for t in tensors):
        return NotImplemented
    first = tensors[0]
    dim = dim % first.ndim
    if any(t.placements != first.placements or t.ndim != first.ndim
           for t in tensors):
        return NotImplemented
    over = _pieces_sharded(first, dim, [t.shape[dim] for t in tensors])
    if over is None:
        return NotImplemented
    mesh, placements = first.device_mesh, first.placements
    whole = [Replicate() if i in over else p for i, p in enumerate(placements)]
    out = _aten.cat.default([t.redistribute(mesh, whole) for t in tensors],
                            dim)
    return out.redistribute(mesh, placements)


def _alike_shards(func, *args):
    """An elementwise op that ``DTensor`` may have no rule for
    (``polar``): each device applies it to its own shards, where every
    input is sharded alike."""
    from torch.distributed.tensor import DTensor

    shards = [a for a in args if isinstance(a, DTensor)]
    first = shards[0]
    if any(a.shape != first.shape or a.placements != first.placements
           or any(p.is_partial() for p in a.placements) for a in shards):
        return NotImplemented
    out = func(*(a._local_tensor if isinstance(a, DTensor) else a
                 for a in args))
    return DTensor.from_local(out, first.device_mesh, first.placements,
                              run_check=False)


def _has_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for x in tree_flatten(tree)[0])


def _local_attention(counter, fn, args, kwargs):
    """Flash attention, forward ``(q, k, v)`` or backward ``(q, k, v, out,
    dout)`` (q-like ``[B, H, S, D]``, kv ``[B, K, S, D]``), over
    ``DTensor``s: each device runs the kernel on its batch rows and query
    heads with the kv heads they read. Where a mesh dimension splits the
    query heads but does not divide K (8 kv heads over 16 devices), the kv
    heads stay whole and each device slices those of its query heads, as
    XLA shards ``[B, K, G, S, D]`` over K and the group G; the backward's
    kv gradients are then partial sums over that dimension. In the
    dry-run's count (``counter.xla``) the backward is billed as XLA's
    autodiff computes it (:func:`_attention_bwd_as_xla`), elsewhere as the
    kernel's plain version on the local shards.
    Returns ``(outputs, billed inputs)``, or ``NotImplemented`` (a sequence
    split, heads split on two mesh dimensions) to leave it to ``DTensor``.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    backward = len(args) == 5
    qs = (args[0],) + tuple(args[3:])
    kv = tuple(args[1:3])
    if not all(isinstance(t, DTensor) for t in qs + kv):
        return NotImplemented
    q, k = qs[0], kv[0]
    mesh = q.device_mesh
    heads, n_kv = q.shape[1], k.shape[1]
    q_want, kv_want, sliced = [], [], None
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            q_want.append(p)
            kv_want.append(p)
        elif isinstance(p, Shard) and p.dim == 1:
            if sliced is not None:
                return NotImplemented
            q_want.append(p)
            if n_kv % mesh.size(i) == 0:
                kv_want.append(p)
            else:
                kv_want.append(Replicate())
                sliced = i
        elif isinstance(p, Shard):
            return NotImplemented
        else:
            q_want.append(Replicate())
            kv_want.append(Replicate())
    # heads that a reshape had to gather (24 heads from a 16-way [.., H *
    # Dh]): XLA tiles them as heads over gcd(n, K) and the head dim over
    # the rest, and each device runs the attention of its block of heads
    block = None
    if sliced is None:
        for i in counter.gathered_heads(q.shape[0], q.shape[2], heads,
                                        q.shape[3]):
            d = math.gcd(mesh.size(i), n_kv)
            if (d > 1 and heads % d == 0 and block is None
                    and q_want[i] == Replicate()):
                block = (i, d)
    ql = [t.redistribute(mesh, q_want)._local_tensor for t in qs]
    kvl = [t.redistribute(mesh, kv_want)._local_tensor for t in kv]
    lo = hi = 0
    if sliced is not None:
        group = heads // n_kv
        local_heads = ql[0].shape[1]
        if local_heads % group and group % local_heads:
            return NotImplemented
        first = mesh.get_coordinate()[sliced] * local_heads
        lo, hi = first // group, (first + local_heads - 1) // group + 1
        kvl = [t[:, lo:hi] for t in kvl]
    share = 1 if sliced is None else mesh.size(sliced) // n_kv
    if block is not None:
        i, d = block
        share = mesh.size(i) // d
        j = mesh.get_coordinate()[i] // share
        hq, lo, hi = heads // d, j * (n_kv // d), (j + 1) * (n_kv // d)
        ql = [t[:, j * hq:(j + 1) * hq] for t in ql]
        kvl = [t[:, lo:hi] for t in kvl]
        q_want[i] = kv_want[i] = Partial()

    def whole(t, first, n):
        """Heads ``first, ...`` of ``[B, n, S, D]``, zero elsewhere (a
        partial sum over the devices that split the heads)."""
        out = t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))
        out[:, first:first + t.shape[1]] = t
        return out

    # with every batch row on each device (the train rules' lookup), XLA
    # splits a kv head's dv by its columns over the devices that share the
    # head (dv [B, S, K, D] sharded 16 ways as K over 8 and D over 2);
    # where it tiles a block of heads, the value product and dP too
    if block is None and any(isinstance(p, Shard) and p.dim == 0
                             for p in q.placements):
        share = 1
    cols = max(ql[0].shape[-1] // max(share, 1), 1)
    if not backward:
        if block is None:
            out = fn(ql[0], *kvl, *ql[1:], **kwargs)
        else:
            out = whole(_attention_fwd_as_xla(ql[0], *kvl, v_cols=cols,
                                              **kwargs), j * hq, heads)
        return (DTensor.from_local(out, mesh, q_want, run_check=False),
                ql + kvl)
    if block is None and not counter.xla:
        # the kernel's own backward on the local shards
        dq, dk, dv = fn(ql[0], *kvl, *ql[1:], **kwargs)
    else:
        dq, dk, dv = _attention_bwd_as_xla(
            counter, ql[0], *kvl, *ql[1:], v_cols=cols,
            dp_split=block is not None, **kwargs)
    if block is not None:
        dq = whole(dq, j * hq, heads)
    grads = [DTensor.from_local(dq, mesh, q_want, run_check=False)]
    if sliced is not None:
        kv_want[sliced] = Partial()
    for g in (dk, dv):
        if sliced is not None or block is not None:
            g = whole(g, lo, n_kv)
        grads.append(DTensor.from_local(g, mesh, kv_want, run_check=False))
    return tuple(grads), ql + kvl


def _scores(q, k, causal):
    """Softmax(q.k^T / sqrt(D)) in float32, ``[B, K, G, S, S]`` (q ``[B,
    H, S, D]``, k ``[B, K, S, D]``), causal where asked."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    scores = torch.einsum("bkgqd,bksd->bkgqs",
                          q.to(torch.float32).reshape(b, kh, h // kh, s, d),
                          k.to(torch.float32)) * d ** -0.5
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[None, :] > pos[:, None], -1e30)
    return torch.softmax(scores, dim=-1)


def _cols(t, cols):
    """``t``'s first ``cols`` columns, and the product of those back at
    ``t``'s width (the rest zero)."""
    d = t.shape[-1]

    def widen(x):
        if x.shape[-1] == d:
            return x
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (d - x.shape[-1],))],
                         dim=-1)
    return t[..., :cols], widen


def _attention_fwd_as_xla(q, k, v, causal=True, v_cols=None):
    """The attention forward (``flash_attention_plain``'s arithmetic) with
    the value product on v's first ``v_cols`` columns only (the rest
    zero): a device's share where XLA tiles the head dim over the devices
    that hold one block of heads."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    p = _scores(q, k, causal).to(q.dtype)
    vc, widen = _cols(v, d if v_cols is None else v_cols)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vc)
    return widen(out.reshape(b, h, s, vc.shape[-1]))


def _attention_bwd_as_xla(counter, q, k, v, o, do, causal=True,
                          v_cols=None, dp_split=False):
    """The attention backward (q, o, do ``[B, H, S, D]``, k, v ``[B, K, S,
    D]``; returns dq, dk, dv) billed as XLA computes the autodiff of the
    reference's ``_sdpa``: the four products dv = P^T.do, dP = do.v^T,
    dq = dS.k and dk = dS^T.q, dv on v's first ``v_cols`` columns only
    (the rest zero), and with ``dp_split`` dP contracted over those columns
    only (a device's partial sum, where XLA tiles v's head dim). XLA keeps
    the forward's probabilities P for the backward, where the kernel
    (``csrc/flash_attention_bwd.cu``, and its plain version) recomputes
    them from q.k^T: that product runs here unbilled. The arithmetic is
    ``flash_attention_bwd_plain``'s."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    f32 = torch.float32
    qf = q.to(f32).reshape(b, kh, g, s, d)
    kf, vf = k.to(f32), v.to(f32)
    dof = do.to(f32).reshape(b, kh, g, s, d)
    with counter.unbilled():
        p = _scores(q, k, causal)
    doc, widen = _cols(dof, d if v_cols is None else v_cols)
    dv = widen(torch.einsum("bkgqs,bkgqd->bksd", p.to(q.dtype).to(f32), doc))
    if dp_split:
        dp = torch.einsum("bkgqd,bksd->bkgqs", doc, vf[..., :doc.shape[-1]])
    else:
        dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    delta = (dof * o.to(f32).reshape(b, kh, g, s, d)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * d ** -0.5
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * d ** -0.5
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _local_decode_attention(counter, fn, args, kwargs):
    """The decode-attention kernel (q ``[B, H, D]``, k, v ``[B, K, S, D]``,
    lengths ``[B]``) over ``DTensor``s, partitioned as XLA partitions the
    reference's decode attention, mesh dimension by mesh dimension: the
    batch rows stay where they lie; a dimension that splits the cache's
    positions splits the keys (q's heads are gathered there, each device
    scores every head over its positions, and the softmax's max and sum
    and the value product's partial sums are all-reduced over it). Where
    q's heads lay on the positions' dimension and a mesh
    dimension of the same size is idle (a one-row long-context decode), XLA
    runs the value product on each device's own heads over that idle
    dimension (a block of heads, kv heads over gcd and the group over the
    rest) and moves the output's heads back onto the positions' dimension
    by one collective-permute (:func:`_decode_values`). Every op runs on
    local shards, so no ``DTensor`` choice (which differs between torch
    versions) enters the count. Returns ``(output, billed inputs)``, or
    ``NotImplemented`` (another placement) to leave it to ``DTensor``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    q, k, v, lengths = args
    if kwargs or not all(isinstance(t, DTensor) for t in (q, k, v)):
        return NotImplemented
    mesh = q.device_mesh
    rep = Replicate()
    rows = (rep, Shard(0))
    q_at, kv_at, row_at, out_at = [], [], [], []
    keys, idle, heads_on_keys = [], [], []
    for i in range(mesh.ndim):
        pq, pk = q.placements[i], k.placements[i]
        if pk != v.placements[i]:
            return NotImplemented
        if pk == Shard(2) and pq in (rep, Shard(1)):   # the cache's positions
            at = (rep, Shard(2), rep, rep)
            keys.append(i)
            if pq == Shard(1):
                heads_on_keys.append(i)
        elif pq == pk == rep:
            at = (rep, rep, rep, rep)
            idle.append(i)
        elif pq in rows and pk in rows:                 # the batch rows
            at = (Shard(0), Shard(0), Shard(0), Shard(0))
        else:
            return NotImplemented
        for acc, a in zip((q_at, kv_at, row_at, out_at), at):
            acc.append(a)
    n_heads, n_kv = q.shape[1], k.shape[1]
    group = n_heads // n_kv
    split = None
    for i in heads_on_keys:
        for j in idle:
            local = n_heads // mesh.size(j)
            if (split is None and mesh.size(j) == mesh.size(i)
                    and n_heads % mesh.size(j) == 0
                    and (group % local == 0 or local % group == 0)):
                split = (j, i)
    ql = q.redistribute(mesh, q_at).to_local()
    kl, vl = (t.redistribute(mesh, kv_at).to_local() for t in (k, v))
    ll = _like(lengths, mesh, row_at)
    b, h, d = ql.shape
    kh, s = kl.shape[1], kl.shape[2]
    first = 0     # the device's first position, mesh dimensions in order
    for i in keys:
        first = first * mesh.size(i) + mesh.get_coordinate()[i]
    scores = torch.einsum("bkgd,bksd->bkgs", ql.reshape(b, kh, h // kh, d),
                          kl).to(torch.float32) * d ** -0.5
    valid = (torch.arange(first * s, (first + 1) * s, device=ql.device)[None]
             < ll.to(ql.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = _split_softmax(scores, mesh, keys).to(ql.dtype)
    if split is None:
        out = torch.einsum("bkgs,bksd->bkgd", probs, vl).reshape(b, h, d)
    else:
        out = _decode_values(mesh, split[0], probs, vl)
    for i in keys:
        out = funcol.all_reduce(out, "sum", (mesh, i))
    if split is not None:
        j, i = split
        at = list(out_at)
        at[j] = Shard(1)
        out_at[i] = Shard(1)
        out = _permuted(DTensor.from_local(out, mesh, at, run_check=False),
                        out_at)
    else:
        out = DTensor.from_local(out, mesh, out_at, run_check=False)
    return out, (ql, kl, vl, ll)


def _split_softmax(scores, mesh, dims):
    """Softmax along the last dimension of ``scores``, which mesh
    dimensions ``dims`` split: the local max and sum all-reduced over
    them."""
    import torch.distributed._functional_collectives as funcol

    m = scores.amax(-1, keepdim=True)
    for i in dims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(scores - m)
    z = e.sum(-1, keepdim=True)
    for i in dims:
        z = funcol.all_reduce(z, "sum", (mesh, i))
    return e / z


def _decode_values(mesh, axis, probs, v):
    """The decode attention's value product (probs ``[B, K, G, S]``, v
    ``[B, K, S, D]``) on the device's own block of the ``H = K * G`` query
    heads over mesh dimension ``axis``: ``[B, H / n, D]``."""
    b, kh, g, s = probs.shape
    local = kh * g // mesh.size(axis)
    first = mesh.get_coordinate()[axis] * local
    k0 = first // g
    if local <= g:    # a share of one kv head's group
        p = probs[:, k0:k0 + 1, first % g:first % g + local]
        vv = v[:, k0:k0 + 1]
    else:             # whole kv heads
        p, vv = probs[:, k0:k0 + local // g], v[:, k0:k0 + local // g]
    return torch.einsum("bkgs,bksd->bkgd", p, vv).reshape(b, local,
                                                         v.shape[-1])


def _mla_partition(fn, args, kwargs):
    """MLA attention (``models/attention.py::_mla_attend``: q ``[B, S, H,
    dn + r]``, the latent c_kv ``[B, T, d_c]`` and rope key k_pe ``[B, T,
    r]``, wkv_b ``[d_c, H * (dn + dv)]``) partitioned as XLA partitions the
    reference's. The batch rows stay where q's lie. A mesh dimension that
    shards q's heads (the "model" axis) shards them on every device: each
    expands its own heads from the whole latent through its own columns of
    wkv_b and attends with them, with no collective. Where a mesh
    dimension shards the latent's positions instead (a decode cache,
    sequence on "model"), that dimension splits the keys, as XLA's
    partition of the reference's decode does: q's heads and wkv_b are
    gathered, each device expands and attends over its slice of the cache,
    and the softmax's max and sum and the output's partial sum are
    all-reduced. Every op runs on local shards, so no ``DTensor`` choice
    (which differs between torch versions) enters the count."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    q, c_kv, k_pe, wkv_b = args[:4]
    kv_len = kwargs.get("kv_len")
    if not all(isinstance(t, DTensor) for t in (q, c_kv, k_pe, wkv_b)):
        return NotImplemented
    mesh = q.device_mesh
    seq = _sharded_on(c_kv, 1)
    if len(seq) > 1:
        return NotImplemented
    rep = Replicate()
    q_at, c_at, w_at, len_at = [], [], [], []
    heads = False
    for i, p in enumerate(q.placements):
        if i in seq:
            at = (rep, Shard(1), rep, rep)
        elif isinstance(p, Shard) and p.dim == 0:
            at = (p, p, rep, p)
        elif isinstance(p, Shard) and p.dim == 2 and not heads:
            heads = True
            at = (p, rep, Shard(1), rep)
        elif isinstance(p, Shard):
            return NotImplemented
        else:
            at = (rep, rep, rep, rep)
        for acc, a in zip((q_at, c_at, w_at, len_at), at):
            acc.append(a)
    q, c_kv, k_pe, wkv_b = (
        t.redistribute(mesh, at) for t, at in
        ((q, q_at), (c_kv, c_at), (k_pe, c_at), (wkv_b, w_at)))
    rest = dict(kwargs)
    if kv_len is not None:
        rest["kv_len"] = _like(kv_len, mesh, len_at)
    local = [t.to_local() for t in (q, c_kv, k_pe, wkv_b)]
    if seq:
        out = _mla_split_keys(mesh, seq[0], *local, *args[4:], **rest)
        if out is NotImplemented:
            return out
    else:
        out = fn(*local, *args[4:], **rest)
    return DTensor.from_local(out, mesh, q_at, run_check=False)


def _mla_split_keys(mesh, axis, q, c_kv, k_pe, wkv_b, dn, dv, causal,
                    kv_len=None):
    """One device's share of MLA attention over keys split on mesh
    dimension ``axis`` (its slice of a decode cache):
    ``models/attention.py::_mla_attend`` on the slice, its softmax's max
    and sum all-reduced over ``axis``, then the output."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.models.attention import _mla_attend

    if causal and q.shape[1] > 1:
        return NotImplemented
    out = _mla_attend(q, c_kv, k_pe, wkv_b, dn, dv, causal, kv_len=kv_len,
                      kv_offset=mesh.get_coordinate()[axis] * c_kv.shape[1],
                      softmax=lambda sc: _split_softmax(sc, mesh, [axis]))
    return funcol.all_reduce(out, "sum", (mesh, axis))


def _wkv_partition(fn, args, kwargs):
    """The WKV recurrence (``models/rwkv6.py::_wkv_scan``: r, k, v, w
    ``[B, S, H, N]``, u ``[H, N]``, the state ``[B, H, N, N]`` or None)
    on each device's batch rows and heads, where the reference's scan body
    runs: each (row, head) is its own recurrence, so no collective; a
    split of the positions or the channels is gathered first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    r, k, v, w, u, state = args
    if not all(isinstance(t, DTensor) for t in (r, k, v, w)) or kwargs:
        return NotImplemented
    mesh = r.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in r.placements]
    heads = [Shard(0) if isinstance(p, Shard) and p.dim == 2 else Replicate()
             for p in rows]
    carried = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
               for p in rows]
    local = [t.redistribute(mesh, rows).to_local() for t in (r, k, v, w)]
    out, state = fn(*local, _like(u, mesh, heads),
                    None if state is None else _like(state, mesh, carried))
    return (DTensor.from_local(out, mesh, rows, run_check=False),
            DTensor.from_local(state, mesh, carried, run_check=False))


def _moe_partition(fn, args, kwargs):
    """The MoE's routed experts (``models/moe.py::_experts``: x3d ``[G, Tg,
    D]``, dispatch and combine ``[G, Tg, E, C]``, we_gate, we_up ``[E, D,
    F]``, we_down ``[E, F, D]``) partitioned as XLA partitions the
    reference's four einsums, mesh dimension by mesh dimension:

    * where the experts are sharded (the "model" axis), each device
      dispatches every token to its own experts and runs them; the
      combined output is a partial sum over the experts;
    * where the tokens' groups are sharded (the serve rules' batch), each
      device runs its own groups; where the tokens of one group are (a
      decode step's), each device dispatches its own tokens, the buffers'
      partial sums are all-reduced, and every device runs the experts on
      the whole buffers;
    * where the tokens' embedding is sharded (the train rules, whose
      lookup replicates the batch), each device runs every group on its
      slice of the embedding with the experts' matching slices; the gate
      and up products are partial sums there, all-reduced before the
      SwiGLU, and the output keeps the slice.

    Every product runs on local shards, forward and backward, so no
    ``DTensor`` choice enters the count."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x3d, dispatch, combine, we_gate, we_up, we_down = args
    if not all(isinstance(t, DTensor)
               for t in (x3d, dispatch, combine, we_gate)) or kwargs:
        return NotImplemented
    mesh = x3d.device_mesh
    rep = Replicate()
    x_at, route_at, w_at, down_at, out_at = [], [], [], [], []
    # the mesh dimensions that split the buffers' contraction (a group's
    # tokens) and the products' (the embedding)
    split = {"buffers": [], "products": []}
    for i, p in enumerate(we_gate.placements):
        xp = x3d.placements[i]
        if p == Shard(0):                       # experts
            at = (rep, Shard(2), Shard(0), Shard(0), Partial())
        elif xp in (Shard(0), Shard(1)):        # groups, or their tokens
            at = (xp, xp, rep, rep, xp)
            if xp == Shard(1):
                split["buffers"].append(i)
        elif xp == Shard(2):                    # the embedding
            at = (xp, rep, Shard(1), Shard(2), xp)
            split["products"].append(i)
        else:
            at = (rep, rep, rep, rep, rep)
        for acc, a in zip((x_at, route_at, w_at, down_at, out_at), at):
            acc.append(a)

    def local(t, at):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [rep] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, at).to_local()

    def reduce(stage, t):
        """Sum a buffer ``[G, E, C, *]``'s partial products over the
        dimensions in ``split[stage]``; it is sharded as the experts and
        groups are elsewhere."""
        at = []
        for i in range(mesh.ndim):
            if i in split[stage]:
                at.append(Partial())
            elif w_at[i] == Shard(0):
                at.append(Shard(1))
            elif route_at[i] == Shard(0):
                at.append(Shard(0))
            else:
                at.append(rep)
        if not any(isinstance(p, Partial) for p in at):
            return t
        done = [rep if isinstance(p, Partial) else p for p in at]
        return DTensor.from_local(t, mesh, at, run_check=False).redistribute(
            mesh, done).to_local()

    out = fn(local(x3d, x_at), local(dispatch, route_at),
             local(combine, route_at), local(we_gate, w_at),
             local(we_up, w_at), local(we_down, down_at), reduce=reduce)
    return DTensor.from_local(out, mesh, out_at, run_check=False)


def _cross_partition(fn, args, kwargs):
    """Cross-attention (``models/encdec.py::cross_attention``: q ``[B, S,
    H, Dh]`` from the decoder, k, v ``[B, S_src, K, Dh]`` from the encoder)
    on each device's batch rows and heads, the rows those of the encoder's
    k and v, as XLA partitions the reference's: the decoder's queries are
    resharded onto the encoder's rows, where ``DTensor`` gathers the
    encoder's keys onto every row of a batch-replicated decoder."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    q, k, v = args[:3]
    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        return NotImplemented
    mesh = q.device_mesh
    q_at, kv_at = [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pk == Shard(0):
            q_at.append(pk)
            kv_at.append(pk)
        elif pq == Shard(2) and k.shape[2] % mesh.size(i) == 0:
            q_at.append(pq)
            kv_at.append(pq)
        else:
            q_at.append(Replicate())
            kv_at.append(Replicate())
    out = fn(q.redistribute(mesh, q_at).to_local(),
             *(t.redistribute(mesh, kv_at).to_local() for t in (k, v)),
             *args[3:], **kwargs)
    return DTensor.from_local(out, mesh, q_at, run_check=False)


def _permuted(t, placements):
    """``t`` (a ``DTensor``) moved onto ``placements``, which give it the
    same local shape, by one collective-permute: each device sends its
    block to one other, as XLA moves a block from one mesh dimension to
    another of the same size, where ``DTensor`` would gather it whole."""
    from torch.distributed.tensor import DTensor

    local = t.to_local()
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            mode.bill_collective("collective-permute", local)
            break
    return DTensor.from_local(local, t.device_mesh, placements,
                              run_check=False)


class _UnembedAsXLA(torch.autograd.Function):
    """``h @ w`` over ``DTensor``s as :func:`_unembed_partition` has it:
    the logits on h's rows split over ``rows_at``, then moved onto
    ``out_at``; h's gradient with the whole of w for each device's rows."""

    @staticmethod
    def forward(ctx, h, w, rows_at, out_at):
        from torch.distributed.tensor import Replicate

        ctx.save_for_backward(h, w)
        ctx.rows_at = rows_at
        mesh = h.device_mesh
        logits = torch.matmul(h.redistribute(mesh, rows_at), w)
        logits = logits.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in logits.placements])
        ctx.logits_at = logits.placements
        return _permuted(logits, out_at)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        h, w = ctx.saved_tensors
        mesh = h.device_mesh
        grad = grad.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in grad.placements])
        grad = _permuted(grad, ctx.logits_at)
        whole = w.redistribute(mesh, [Replicate()] * mesh.ndim)
        dh = torch.matmul(grad, whole.transpose(0, 1))
        hr = h.redistribute(mesh, ctx.rows_at)
        dw = torch.matmul(hr.reshape(-1, hr.shape[-1]).transpose(0, 1),
                          grad.reshape(-1, grad.shape[-1]))
        return (dh.redistribute(mesh, h.placements),
                dw.redistribute(mesh, w.placements), None, None)


def _unembed_partition(fn, args, kwargs):
    """The unembedding ``h [B, S, D] @ w [D, V]`` of a train step whose
    vocabulary is not sharded (it does not divide the axis: Seamless's
    256 206; h batch-replicated and embedding-sharded, as the train rules'
    lookup leaves it), partitioned as XLA partitions the reference's: h's
    rows are split over the mesh dimension that neither h nor w uses, the
    logits' partial sums over the embedding's dimension all-reduced, and
    the logits then moved onto the embedding's dimension (one
    collective-permute), where the loss's labels lie; in the backward the
    same move back, w's gradient on the same split, and h's gradient
    computed with the whole of w for each device's rows, on every device
    of the embedding's dimension (the reference's count has that product
    16 times over). A sharded vocabulary, no gradient or any other
    placement is left to ``DTensor``, whose partition is XLA's there."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    h, w = args
    if (not isinstance(h, DTensor) or not isinstance(w, DTensor) or kwargs
            or h.ndim != 3 or not torch.is_grad_enabled()
            or not h.requires_grad):
        return NotImplemented
    mesh = h.device_mesh
    embed = [i for i, (ph, pw) in enumerate(zip(h.placements, w.placements))
             if ph == Shard(2) and pw == Shard(0)]
    idle = [i for i, (ph, pw) in enumerate(zip(h.placements, w.placements))
            if ph == Replicate() and pw == Replicate()]
    if (len(embed) != 1 or len(idle) != 1 or len(embed) + len(idle)
            != mesh.ndim or mesh.size(embed[0]) != mesh.size(idle[0])
            or h.shape[0] % mesh.size(idle[0])):
        return NotImplemented
    rows_at, out_at = list(h.placements), [Replicate()] * mesh.ndim
    rows_at[idle[0]] = Shard(0)
    out_at[embed[0]] = Shard(0)
    return _UnembedAsXLA.apply(h, w, rows_at, out_at)


def _cross_entropy_partition(fn, args, kwargs):
    """The cross-entropy (``models/common.py::_cross_entropy``: float32
    logits ``[..., V]``, int labels ``[...]``, a mask or None) on the
    logits' own shards, as XLA partitions the reference's: the labels and
    the mask taken onto the logits' rows; each row's max, sum of
    exponentials and label logit all-reduced over the mesh dimensions that
    split the vocabulary (each device picks the labels in its slice); the
    mean summed over the dimensions that split the rows. Forward and
    backward run on local shards, so that the loss's gradient keeps the
    logits' sharding (``DTensor``'s versions part ways on the gather's
    backward: torch 2.11 left it whole on every device, and the
    unembedding's weight gradient with it)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    logits, labels = args[:2]
    mask = args[2] if len(args) > 2 else kwargs.get("mask")
    if not isinstance(logits, DTensor):
        return NotImplemented
    mesh, last = logits.device_mesh, logits.ndim - 1
    rows_at, vocab, rows = [], [], []
    for i, p in enumerate(logits.placements):
        if p.is_partial():
            return NotImplemented
        if isinstance(p, Shard) and p.dim == last:
            vocab.append(i)
            rows_at.append(Replicate())
        else:
            if isinstance(p, Shard):
                rows.append(i)
            rows_at.append(p)

    def summed(t, dims):
        """``t`` summed over the mesh dimensions ``dims`` (its gradient
        too)."""
        if not dims:
            return t
        return DTensor.from_local(t, mesh, [
            Partial() if i in dims else Replicate()
            for i in range(mesh.ndim)], run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()

    x = logits.to_local()
    lab = _like(labels, mesh, rows_at).long()
    m = x.detach().amax(-1, keepdim=True)
    for i in vocab:
        m = funcol.all_reduce(m, "max", (mesh, i))
    logz = m[..., 0] + torch.log(summed(torch.exp(x - m).sum(-1), vocab))
    size, first = x.shape[-1], 0
    for i in vocab:    # the slice's first column, mesh dimensions in order
        first = first * mesh.size(i) + mesh.get_coordinate()[i]
    at = lab - first * size
    inside = (at >= 0) & (at < size)
    gold = torch.gather(x, -1, at.clamp(0, size - 1)[..., None])[..., 0]
    nll = logz - summed(gold * inside, vocab)
    if mask is None:
        loss = summed(nll.sum(), rows) / labels.numel()
    else:
        msk = _like(mask, mesh, rows_at)
        loss = summed((nll * msk).sum(), rows) / torch.clamp(
            summed(msk.sum(), rows), min=1.0)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _layer_partition(fn, args, kwargs):
    """A block of a layer loop (``models/transformer.py::remat_call``,
    ``args`` ``(block fn, remat, block, h, ...)``), run as written, its
    output hidden state placed as ``h`` was: XLA's scan over the layers
    keeps one sharding for its carry, where ``DTensor``'s choices inside a
    block may leave it on others (a decoder block's cross-attention,
    batch-sharded by the encoder's output, turning the batch-replicated
    stream batch-sharded)."""
    from torch.distributed.tensor import DTensor

    out = fn(*args, **kwargs)
    new, h = (out[0] if isinstance(out, tuple) else out), args[3]
    if (isinstance(new, DTensor) and isinstance(h, DTensor)
            and new.placements != h.placements):
        new = new.redistribute(h.device_mesh, h.placements)
    return (new,) + tuple(out[1:]) if isinstance(out, tuple) else new


_PARTITIONS = {"mla_attention": _mla_partition, "wkv_scan": _wkv_partition,
               "layer": _layer_partition,
               "moe_experts": _moe_partition,
               "cross_attention": _cross_partition,
               "unembed": _unembed_partition,
               "cross_entropy": _cross_entropy_partition}


def _rmsnorm_bwd_on_x(counter, fn, args, kwargs):
    """The RMSNorm backward, ``(x, gain, dy)`` once or twice (the q/k
    pair), over ``DTensor``s: each dy on its x's sharding, as XLA computes
    a gradient on its primal's tiling, where ``DTensor`` would pick a
    placement for the mix of a batch-sharded gradient (the loss's, whose
    labels are sharded on the batch) and an embedding-sharded x (the train
    rules' activations), and reshape it into shardings no later reshape
    can take."""
    from torch.distributed.tensor import DTensor

    if not _has_dtensor((args, kwargs)):
        return NotImplemented
    args = list(args)
    for j in range(0, len(args) - 2, 3):
        x, dy = args[j], args[j + 2]
        if (isinstance(x, DTensor) and isinstance(dy, DTensor)
                and dy.placements != x.placements):
            args[j + 2] = dy.redistribute(x.device_mesh, x.placements)
    return fn(*args, **kwargs), (args, kwargs)


_LOCAL_KERNELS = {
    "flash_attention": _local_attention,
    "flash_attention_bwd": _local_attention,
    "decode_attention": _local_decode_attention,
    "rmsnorm_bwd": _rmsnorm_bwd_on_x,
}


_XLA_RULES = {
    _aten.index.Tensor: _index_as_embedding,
    _aten.embedding.default: _lookup,
    _aten._softmax.default:
        lambda x, dim, half: _softmax_parts(x, dim, log=False),
    _aten._log_softmax.default:
        lambda x, dim, half: _softmax_parts(x, dim, log=True),
    _aten._softmax_backward_data.default:
        lambda g, y, dim, dtype: _softmax_bwd_parts(g, y, dim, log=False),
    _aten._log_softmax_backward_data.default:
        lambda g, y, dim, dtype: _softmax_bwd_parts(g, y, dim, log=True),
    _aten.index_copy_.default: _index_copy_in_place,
    _aten.index_put.default: _rows_added,
    _aten.polar.default: lambda *a: _alike_shards(_aten.polar.default, *a),
    _aten.split.Tensor: _split_sharded,
    _aten.split_with_sizes.default: _split_sharded,
    _aten.cat.default: _cat_sharded,
}


class CostCounter(TorchDispatchMode):
    """Bill every op run under it (see the module docstring); read
    :meth:`metrics`, :meth:`collectives` and ``peak_bytes`` after."""

    def __init__(self, grad_placements=None, ledger: bool = False,
                 as_xla: bool = False):
        super().__init__()
        # the dry-run's count, held against the reference's: a product of
        # a contraction of size 1 and the attention backward billed as XLA
        # computes them; otherwise as the port's kernels run
        self.xla = as_xla
        # with ``ledger``: flops by (phase, rule, op, result shape) and
        # collective bytes by (phase, rule, kind), phase "fw" or the
        # backward node that ran the op, rule the kernel or partition
        # whose run billed it ("-" for none): ``tools/dryrun_diff.py``
        self.ledger = {} if ledger else None
        self.coll_ledger = {} if ledger else None
        self._rules = []
        # {global shape: placements} of the parameters whose gradients a
        # sharded train step reduces (see ``_reduce_partial``)
        self.grad_placements = dict(grad_placements or {})
        self._reduced = {}
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._fused = 0   # > 0 inside a kernel's plain version
        self._weight = 1  # the trips each op billed now stands for
        self._in_dtensor = False   # inside this mode's own DTensor op
        # (first, end, weight): the autograd nodes made inside a trips()
        # block, by sequence number, whose backward is billed alike
        self._loops = []
        # {(reshaped shape, source shape): the source's placements} of
        # the reshapes that gathered their source (``_gather_reshaped``)
        self._gathered = {}

    @contextlib.contextmanager
    def trips(self, n: int):
        """Bill every op run inside ``n`` times: one trip of a loop of
        ``n`` trips alike (``kernels/checks.py::time_loop``), and the
        backward of that trip, when a gradient is taken, ``n`` times too
        (XLA's backward of a scan is a loop of as many trips)."""
        outer = self._weight
        self._weight = outer * max(int(n), 1)
        first = torch._C._autograd._get_sequence_nr()
        try:
            yield
        finally:
            self._loops.append((first, torch._C._autograd._get_sequence_nr(),
                                self._weight))
            self._weight = outer

    @contextlib.contextmanager
    def unbilled(self):
        """Run the ops inside without billing them (a product that the
        reference's program does not compute, see
        :func:`_attention_bwd_as_xla`)."""
        outer, self._weight = self._weight, 0
        try:
            yield
        finally:
            self._weight = outer

    def _weight_now(self) -> int:
        """The trips the op dispatched now stands for: the enclosing
        ``trips`` blocks', or in a backward, those of the block that made
        the autograd node running it."""
        if self._weight != 1 or not self._loops:
            return self._weight
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        return max([w for first, end, w in self._loops
                    if first <= seq < end], default=1)

    def run_plain(self, kernel: str, fn, args, kwargs):
        """Run a kernel's plain version and bill it as the kernel (the
        hook ``kernels/checks.py::run_plain`` finds on the innermost mode
        that has one). Over ``DTensor``s a kernel with a local rule runs
        on each device's shards, as the kernel would on each card."""
        self._fused += 1
        self._rules.append(kernel)
        try:
            out = NotImplemented
            local = _LOCAL_KERNELS.get(kernel)
            if local is not None:
                out = local(self, fn, args, kwargs)
            if out is NotImplemented:
                out, billed = fn(*args, **kwargs), (args, kwargs)
            else:
                out, billed = out
        finally:
            self._fused -= 1
            self._rules.pop()
        self.bytes += self._weight_now() * float(
            sum(_nbytes(t) for t in _tensors(billed))
            + sum(_nbytes(t) for t in _tensors(out)))
        return out

    def run_partitioned(self, name: str, fn, args, kwargs):
        """Run a piece of plain torch (``kernels/checks.py::partitioned``)
        over ``DTensor``s by its rule in ``_PARTITIONS``, its ops billed
        as any other; elsewhere, or where the rule does not apply, as
        written."""
        rule = _PARTITIONS.get(name)
        self._rules.append(name)
        try:
            if rule is not None and _has_dtensor((args, kwargs)):
                args, kwargs = tree_map(self._reduce_partial, (args, kwargs))
                out = rule(fn, args, kwargs)
                if out is not NotImplemented:
                    return out
            return fn(*args, **kwargs)
        finally:
            self._rules.pop()

    def _entry(self, *what) -> tuple:
        """A ledger key: the phase and rule of the op billed now, then
        ``what``."""
        node = torch._C._current_autograd_node()
        return (("bw " + node.name()) if node is not None else "fw",
                self._rules[-1] if self._rules else "-") + what

    def bill_collective(self, kind: str, out: torch.Tensor) -> None:
        """Bill one collective of ``kind`` whose result is ``out`` (a
        partition's move that no ``c10d`` op stands for, see
        :func:`_permuted`)."""
        w = self._weight_now()
        self.coll_bytes[kind] += w * _nbytes(out)
        self.coll_counts[kind] += w
        if self.coll_ledger is not None:
            key = self._entry(kind)
            self.coll_ledger[key] = (self.coll_ledger.get(key, 0.0)
                                     + w * _nbytes(out))

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _reduce_partial(self, x):
        """``x`` with its partial sums reduced, once however many ops read
        it: XLA reduces a product's partial result where it is made, where
        ``DTensor`` may carry it on into the next product (which every
        device then computes whole) or reduce it again for every reader. A
        gradient (a partial of a parameter's shape in ``grad_placements``)
        is reduced onto its parameter's sharding, as XLA reduce-scatters
        it; anything else is all-reduced."""
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(x, DTensor) or not any(p.is_partial()
                                                 for p in x.placements):
            return x
        done = self._reduced.get(id(x))
        if done is not None:
            return done
        target = self.grad_placements.get(tuple(x.shape))
        if target is None:
            target = [Replicate() if p.is_partial() else p
                      for p in x.placements]
        done = x.redistribute(x.device_mesh, target)
        self._reduced[id(x)] = done
        weakref.finalize(x, self._reduced.pop, id(x), None)
        return done

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                # let the DTensor run its sharding rule; its local ops and
                # the collectives it issues come back here
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            # a sharding rule's shape propagation at the global shape
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if (func in _FREE or not isinstance(func, torch._ops.OpOverload)
                or func._schema.name in _FREE_NAMES):
            return out
        w = self._weight_now()
        self.ops += w
        packet = func._overloadpacket
        if packet in flop_registry and not (self.xla
                                            and _outer_product(packet, args)):
            flops = w * float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
            self.flops += flops
            if self.ledger is not None and flops:
                key = self._entry(packet.__name__, "x".join(
                    str(n) for n in getattr(out, "shape", ())))
                self.ledger[key] = self.ledger.get(key, 0.0) + flops
        kind = _collective_kind(func)
        if kind:
            nbytes = sum(_nbytes(t) for t in _tensors(out))
            self.coll_bytes[kind] += w * nbytes
            self.coll_counts[kind] += w
            if self.coll_ledger is not None:
                key = self._entry(kind)
                self.coll_ledger[key] = (self.coll_ledger.get(key, 0.0)
                                         + w * nbytes)
        if func.is_view or self._fused:
            return out
        self.bytes += w * self._op_bytes(func, args, kwargs, out)
        return out

    def _op_bytes(self, func, args, kwargs, out) -> float:
        schema = func._schema
        written = set()
        read = 0
        values = list(args) + [kwargs.get(a.name) for a in
                               schema.arguments[len(args):]]
        if func in _GATHERS:
            # the source reads as many bytes as the gather writes
            source = args[0] if func is not _aten.embedding.default else None
            values = [None if v is source else v for v in values]
            read += sum(_nbytes(t) for t in _tensors(out))
        for arg, value in zip(schema.arguments, values):
            for t in _tensors(value):
                if arg.alias_info is not None and arg.alias_info.is_write:
                    written.add(id(t))
                    if not schema.name.endswith(_WRITE_ONLY):
                        read += _nbytes(t)
                else:
                    read += _nbytes(t)
        write = 0
        for t in _tensors(out):
            write += _nbytes(t)
            if id(t) not in written:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return float(read + write)

    def _dtensor_op(self, func, args, kwargs):
        """One op on ``DTensor``s, by its sharding rule, resharded where
        ``DTensor`` and XLA's partitioner part ways (see the module
        docstring)."""
        self._in_dtensor = True
        try:
            with self:
                args, kwargs = tree_map(self._reduce_partial, (args, kwargs))
                rule = _XLA_RULES.get(func)
                out = rule(*args, **kwargs) if rule else NotImplemented
                if out is NotImplemented:
                    try:
                        out = func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError):
                        if func not in _RESHAPES:
                            raise
                        out = self._gather_reshaped(func, args, kwargs)
                    else:
                        if func in _RESHAPES:
                            out = self._reshard_merged(args[0], out)
                return out
        finally:
            self._in_dtensor = False

    def _gather_reshaped(self, func, args, kwargs):
        """A reshape that ``DTensor`` cannot shard (``[..., 1024]`` split
        16 ways cut into 8 heads of 128) on its source gathered over the
        dimensions it reshapes; XLA keeps such a tiling (K over 8, D over
        2), which :meth:`_reshard_merged` restores on the way back."""
        from torch.distributed.tensor import Replicate, Shard

        x, size = args[0], list(args[1])
        keep = 0
        while (keep < min(x.ndim, len(size))
               and x.shape[keep] == size[keep]):
            keep += 1
        placements = [Replicate() if isinstance(p, Shard) and p.dim >= keep
                      else p for p in x.placements]
        before = tuple(x.placements)
        x = x.redistribute(x.device_mesh, placements)
        out = func(x, *args[1:], **kwargs)
        self._gathered[(tuple(out.shape), tuple(x.shape))] = before
        return out

    def gathered_heads(self, b: int, s: int, h: int, d: int):
        """The mesh dimensions that sharded ``[b, s, h * d]`` before a
        reshape into ``[b, s, h, d]`` gathered it (:meth:`_gather_reshaped`:
        heads that do not divide the axis)."""
        from torch.distributed.tensor import Shard

        return [i for (out, src), before in self._gathered.items()
                if out == (b, s, h, d) and len(src) == 3
                for i, p in enumerate(before) if p == Shard(2)]

    def _reshard_merged(self, x, out):
        """A reshape that undoes one that gathered its source
        (:meth:`_gather_reshaped`): the gradient on its way back, or the
        heads merged again after attention. The result takes the source's
        sharding again, each device keeping its own slice of the
        replicated tensor (no collective), as XLA keeps the tiling, so that
        the products that read it (the output projection, a projection's
        weight gradient) run on each device's columns."""
        from torch.distributed.tensor import Replicate

        before = self._gathered.get((tuple(x.shape), tuple(out.shape)))
        if before is None or not all(o == b or isinstance(o, Replicate)
                                     for o, b in zip(out.placements,
                                                     before)):
            return out
        return out.redistribute(out.device_mesh, before)

    def metrics(self) -> Dict[str, float]:
        """{flops, bytes} per device: ``hlo_metrics``' keys."""
        return {"flops": self.flops, "bytes": self.bytes}

    def collectives(self) -> Dict[str, dict]:
        """``collective_bytes``' record: bytes and counts by kind."""
        b = dict(self.coll_bytes)
        b["total"] = sum(self.coll_bytes.values())
        return {"bytes": b, "counts": dict(self.coll_counts)}


def count(fn, *args, **kwargs) -> Tuple[object, CostCounter]:
    """(``fn(*args, **kwargs)``, the counter that billed it)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter


def graph_metrics(fn, *args, **kwargs) -> Dict[str, float]:
    """Trip-count-weighted {flops, bytes} of one run of ``fn``: the
    counterpart of ``hlo_metrics`` on the reference's compiled text."""
    return count(fn, *args, **kwargs)[1].metrics()


def collective_bytes(fn, *args, **kwargs) -> Dict[str, dict]:
    """Trip-count-weighted collective traffic of one run of ``fn``:
    {"bytes": {kind: bytes, "total": ...}, "counts": {kind: n}}."""
    return count(fn, *args, **kwargs)[1].collectives()


__all__ = ["COLLECTIVE_OPS", "CostCounter", "collective_bytes", "count",
           "graph_metrics"]
