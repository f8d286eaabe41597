"""The rmsnorm backward's launch plan (``kernels/rmsnorm/ops.py::bwd_plan``),
a pure Python function the CUDA entry takes and checks: its layout at the
trained shapes, the blocks' cover of the rows, the pair's split of the
blocks, its independence of the device and the bound on the partial.

The kernel itself is held against its plain version on the card by
``tests/test_torch_train_cuda.py``; nothing here needs a card.
"""

import pytest
import torch

from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ops import bwd_plan, bwd_row_threads

BF16, F32 = torch.bfloat16, torch.float32
B, S = 8, 256  # the trained batch and sequence

# (rows, D, dtype, aligned) -> layout, at the shapes training runs
LAYOUTS = [
    ((B * S, 576, BF16, True), "block"),         # SmolLM-135M's residual
    ((B * S, 512, BF16, True), "rows"),          # 64 vectors a row
    ((B * S, 3072, BF16, True), "block"),        # Phi-4-mini's
    ((B * S, 4096, BF16, True), "block"),        # Qwen3-8B's
    ((B * S * 32, 128, BF16, True), "rows"),     # Qwen3-8B's q norm
    ((B * S * 8, 128, BF16, True), "rows"),      # and its k norm
    ((1000, 4096, BF16, True), "block"),
    ((B * S, 100, BF16, True), "scalar"),        # 200-byte rows
    ((B * S, 100, F32, True), "rows"),           # 400 bytes: 25 vectors
    ((B * S, 4096, BF16, False), "scalar"),      # an offset view
    ((B * S, 7168, BF16, True), "block"),        # DeepSeek-V3's residual
    ((B * S, 16384, BF16, True), "scalar"),      # past 1024 vectors
    ((B * S, 4096, F32, True), "block"),
]


@pytest.mark.parametrize("args, layout", LAYOUTS, ids=str)
def test_layout_at_the_trained_shapes(args, layout):
    assert bwd_plan(*args)[0] == layout


@pytest.mark.parametrize("args", [a for a, _ in LAYOUTS], ids=str)
def test_blocks_cover_the_rows_exactly(args):
    rows = args[0]
    layout, blocks, per = bwd_plan(*args)
    assert per >= 1 and blocks >= 1
    assert (blocks - 1) * per < rows <= blocks * per
    # a whole number of rounds of the block's rows in flight
    assert per % bwd_row_threads(layout, args[1], args[2])[1] == 0


@pytest.mark.parametrize("args", [a for a, _ in LAYOUTS], ids=str)
def test_partial_is_bounded(args):
    rows = args[0]
    _, blocks, _ = bwd_plan(*args)
    # at most an eighth of the rows and about the target blocks, so the
    # [blocks, D] float32 partial stays a small share of x, dy and dx
    assert blocks <= -(-rows // ops.MIN_ROWS_PER_BLOCK)
    assert blocks <= ops.TARGET_BLOCKS


def test_large_tensors_fill_the_card_several_times():
    for rows, d in ((B * S * 32, 128), (B * S * 8, 128), (B * S, 4096)):
        assert bwd_plan(rows, d, BF16, True)[1] >= 132


def test_pair_blocks_do_not_overlap():
    """The pair's launch gives blocks [0, bq) to q and the rest to k, as
    the kernel picks its tensor: every row of each is in exactly one
    block, and no block holds rows of both."""
    tq, tk, d = B * S * 32, B * S * 8, 128
    lq, bq, pq = bwd_plan(tq, d, BF16, True)
    lk, bk, pk = bwd_plan(tk, d, BF16, True)
    assert lq == lk  # one launch, one kernel
    seen = {"q": [], "k": []}
    for block in range(bq + bk):
        name, i, per, t = (("q", block, pq, tq) if block < bq
                           else ("k", block - bq, pk, tk))
        seen[name].append(range(i * per, min((i + 1) * per, t)))
    for name, t in (("q", tq), ("k", tk)):
        rows = [r for run in seen[name] for r in run]
        assert rows == list(range(t))


def test_plan_depends_on_nothing_but_its_arguments(monkeypatch):
    want = [bwd_plan(*a) for a, _ in LAYOUTS]

    def no_device(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    assert [bwd_plan(*a) for a, _ in LAYOUTS] == want
    assert [bwd_plan(*a) for a, _ in LAYOUTS] == want


def test_empty_rows_take_no_block():
    assert bwd_plan(0, 128, BF16, True)[1] == 0


def test_scalar_layout_refuses_a_width_it_cannot_hold():
    with pytest.raises(ValueError, match="scalar"):
        bwd_plan(4, ops.SCALAR_MAX_D + 1, BF16, False)
