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
  reference counts dots only.
* **bytes**: each op's tensor inputs and its fresh outputs at their own
  sizes: eager torch runs each op as its own kernel, which moves just that.
  A hand-written kernel's wrapper, which takes its plain version on
  ``meta`` and CPU tensors, is billed as the kernel: one fused op whose
  inputs are read once and outputs written once (the plain version's flops
  are kept), as XLA bills a fusion by its operands and results. Views
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
  placements, not the values). Outside a counter the loop runs every trip.

Over ``DTensor``s (a sharded program on a ``DeviceMesh``) the mode lets
each ``DTensor`` op run its sharding rule and counts the local ops and the
collectives it issues: the numbers are this rank's, per device, as the
reference's are of the SPMD-partitioned program. ``DTensor`` picks each
op's placements by the cheapest redistribution alone, and where that is
not what XLA's partitioner does (which would count work that XLA does not
do, or miss work it does), the counter partitions as XLA does:

* a partial sum is reduced once, at its first reader, all-reduced (or,
  for a gradient, reduce-scattered onto its parameter's sharding), not
  carried into the next product, which every device would compute whole;
* a lookup (``table[rows]``) gathers the table on the mesh dimensions
  that shard its rows' indices, so the output keeps the batch sharding,
  and looks a vocab-sharded table up where its rows lie;
* a softmax along a sharded dimension all-reduces its row max and sum;
  a row written into a sharded dimension (a decode step's cache) is
  written into its shard; rows added into a table (a lookup's backward)
  are added on each device into a partial table;
* the flash-attention kernel runs on each device's batch rows and query
  heads with the kv heads they read, also where a mesh dimension splits
  the query heads but not the kv heads;
* MLA attention (``models/attention.py::_mla_attend``) runs with its
  heads on the mesh dimension that shards them, or, where a decode cache
  shards the keys' positions, split on those positions
  (:func:`_mla_partition`); the WKV recurrence on each device's rows and
  heads (:func:`_wkv_partition`): both on local shards, so that no
  ``DTensor`` choice, which differs between torch 2.11 and 2.13, enters
  the count;
* a reshape that ``DTensor`` cannot shard (a dimension split 16 ways cut
  into 8 heads) gathers the dimensions it reshapes, as XLA reshards.

An op with no sharding rule raises: the dry-run writes the cell's
``"error"`` record, never a count of the op run replicated.
``tests/test_torch_dryrun_reference.py`` holds the result against the
reference's ``lower_cell`` on depth-cut cells.

``CostCounter.peak_bytes`` is the peak of the bytes held by the op outputs
still alive during the run (arguments excluded), the counterpart of
``memory_analysis``'s temporaries.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
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
    return t.redistribute(mesh, placements)._local_tensor


def _lookup(table, rows, *rest):
    """``embedding(table, rows)`` partitioned as XLA partitions a lookup:
    the table gathered on the mesh dimensions that shard the rows' indices
    (an FSDP-sharded embedding is all-gathered over the batch axes), so
    that each device looks up its own rows and the output keeps the batch
    sharding; a vocab-sharded table looked up where its rows lie, and the
    masked rows summed over the shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(table, DTensor) and isinstance(rows, DTensor):
        table = table.redistribute(table.device_mesh, [
            Replicate() if isinstance(r, Shard) else p
            for p, r in zip(table.placements, rows.placements)])
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
    backward, the gradient rows into a zero table): each device adds its
    own rows into a whole table, which is then a partial sum over the mesh
    dimensions that shard the rows, as XLA partitions a scatter-add."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if (not accumulate or len(indices) != 1 or indices[0] is None
            or not isinstance(table, DTensor)):
        return NotImplemented
    mesh, rows = table.device_mesh, indices[0]
    split = (list(rows.placements) if isinstance(rows, DTensor)
             else [Replicate()] * mesh.ndim)
    if any(p.is_partial() for p in split):
        return NotImplemented
    out = _aten.index_put.default(
        _like(table, mesh, [Replicate()] * mesh.ndim),
        [_like(rows, mesh, split)], _like(values, mesh, split), True)
    return DTensor.from_local(out, mesh, [
        Partial() if isinstance(p, Shard) else Replicate() for p in split],
        run_check=False)


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


def _local_attention(fn, args, kwargs):
    """Flash attention, forward ``(q, k, v)`` or backward ``(q, k, v, out,
    dout)`` (q-like ``[B, H, S, D]``, kv ``[B, K, S, D]``), over
    ``DTensor``s: each device runs the kernel on its batch rows and query
    heads with the kv heads they read. Where a mesh dimension splits the
    query heads but does not divide K (8 kv heads over 16 devices), the kv
    heads stay whole and each device slices those of its query heads, as
    XLA shards ``[B, K, G, S, D]`` over K and the group G; the backward's
    kv gradients are then partial sums over that dimension. Returns
    ``(outputs, billed inputs)``, or ``NotImplemented`` (a sequence
    split, heads split on two mesh dimensions) to leave it to ``DTensor``.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
    out = fn(ql[0], *kvl, *ql[1:], **kwargs)
    if isinstance(out, torch.Tensor):   # the forward
        return (DTensor.from_local(out, mesh, q_want, run_check=False),
                ql + kvl)
    dq, dk, dv = out
    grads = [DTensor.from_local(dq, mesh, q_want, run_check=False)]
    if sliced is not None:
        kv_want[sliced] = Partial()
    for g in (dk, dv):
        if sliced is not None:
            full = g.new_zeros((g.shape[0], n_kv) + tuple(g.shape[2:]))
            full[:, lo:hi] = g
            g = full
        grads.append(DTensor.from_local(g, mesh, kv_want, run_check=False))
    return tuple(grads), ql + kvl


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
    local = [t._local_tensor for t in (q, c_kv, k_pe, wkv_b)]
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

    def softmax(scores):
        m = funcol.all_reduce(scores.amax(-1, keepdim=True), "max",
                              (mesh, axis))
        e = torch.exp(scores - m)
        return e / funcol.all_reduce(e.sum(-1, keepdim=True), "sum",
                                     (mesh, axis))

    out = _mla_attend(q, c_kv, k_pe, wkv_b, dn, dv, causal, kv_len=kv_len,
                      kv_offset=mesh.get_coordinate()[axis] * c_kv.shape[1],
                      softmax=softmax)
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
    local = [t.redistribute(mesh, rows)._local_tensor for t in (r, k, v, w)]
    out, state = fn(*local, _like(u, mesh, heads),
                    None if state is None else _like(state, mesh, carried))
    return (DTensor.from_local(out, mesh, rows, run_check=False),
            DTensor.from_local(state, mesh, carried, run_check=False))


_PARTITIONS = {"mla_attention": _mla_partition, "wkv_scan": _wkv_partition}


_LOCAL_KERNELS = {
    "flash_attention": _local_attention,
    "flash_attention_bwd": _local_attention,
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
}


class CostCounter(TorchDispatchMode):
    """Bill every op run under it (see the module docstring); read
    :meth:`metrics`, :meth:`collectives` and ``peak_bytes`` after."""

    def __init__(self, grad_placements=None):
        super().__init__()
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

    @contextlib.contextmanager
    def trips(self, n: int):
        """Bill every op run inside ``n`` times: one trip of a loop of
        ``n`` trips alike (``kernels/checks.py::time_loop``)."""
        outer = self._weight
        self._weight = outer * max(int(n), 1)
        try:
            yield
        finally:
            self._weight = outer

    def run_plain(self, kernel: str, fn, args, kwargs):
        """Run a kernel's plain version and bill it as the kernel (the
        hook ``kernels/checks.py::run_plain`` finds on the innermost mode
        that has one). Over ``DTensor``s a kernel with a local rule runs
        on each device's shards, as the kernel would on each card."""
        self._fused += 1
        try:
            out = NotImplemented
            local = _LOCAL_KERNELS.get(kernel)
            if local is not None and _has_dtensor((args, kwargs)):
                out = local(fn, args, kwargs)
            if out is NotImplemented:
                out, billed = fn(*args, **kwargs), (args, kwargs)
            else:
                out, billed = out
        finally:
            self._fused -= 1
        self.bytes += self._weight * float(
            sum(_nbytes(t) for t in _tensors(billed))
            + sum(_nbytes(t) for t in _tensors(out)))
        return out

    def run_partitioned(self, name: str, fn, args, kwargs):
        """Run a piece of plain torch (``kernels/checks.py::partitioned``)
        over ``DTensor``s by its rule in ``_PARTITIONS``, its ops billed
        as any other; elsewhere, or where the rule does not apply, as
        written."""
        rule = _PARTITIONS.get(name)
        if rule is not None and _has_dtensor((args, kwargs)):
            args, kwargs = tree_map(self._reduce_partial, (args, kwargs))
            out = rule(fn, args, kwargs)
            if out is not NotImplemented:
                return out
        return fn(*args, **kwargs)

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
        w = self._weight
        self.ops += w
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += w * float(flop_registry[packet](*args, **kwargs,
                                                          out_val=out))
        kind = _collective_kind(func)
        if kind:
            nbytes = sum(_nbytes(t) for t in _tensors(out))
            self.coll_bytes[kind] += w * nbytes
            self.coll_counts[kind] += w
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
                return out
        finally:
            self._in_dtensor = False

    @staticmethod
    def _gather_reshaped(func, args, kwargs):
        from torch.distributed.tensor import Replicate, Shard

        x, size = args[0], list(args[1])
        keep = 0
        while (keep < min(x.ndim, len(size))
               and x.shape[keep] == size[keep]):
            keep += 1
        placements = [Replicate() if isinstance(p, Shard) and p.dim >= keep
                      else p for p in x.placements]
        x = x.redistribute(x.device_mesh, placements)
        return func(x, *args[1:], **kwargs)

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
