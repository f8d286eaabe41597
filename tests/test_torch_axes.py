"""The port's shape-only evaluation against the JAX reference on the CPU:
every parameter's logical axes and shape (``abstract_params``) for the ten
FULL LM configs, path for path; the dry-run's shape table
(``configs/shapes.py``): ``input_specs`` (decode caches included) against
the reference's ``eval_shape``, ``applicable`` and ``skip_reason``; and the
dry-run's ``_active_params`` / ``_model_flops`` for every arch x shape cell.
A meta build allocates nothing and draws nothing; axes do not change one
bit of a real build.
"""

import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.models import build_model as ref_build_model

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    applicable,
    get_config,
    input_specs,
    skip_reason,
)
from repro_torch.distributed.sharding import tree_leaves
from repro_torch.launch.dryrun import _active_params, _model_flops
from repro_torch.models import build_model
from repro_torch.models.common import (
    abstract_params,
    make_param,
    meta_generator,
    param_axes,
)

from torch_dist import (
    ref_dryrun,
    ref_leaves,
    ref_per_layer,
    torch_dtype_name,
)

torch.set_num_threads(1)

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _port_abstract(arch):
    cfg = get_config(arch)
    return abstract_params(lambda dev: build_model(cfg, device=dev))


@pytest.fixture(scope="module")
def ref_abstract():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = ref_build_model(ref_get_config(arch)).abstract(
                jax.random.key(0))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_and_shapes_equal_the_reference(arch, ref_abstract):
    shapes, axes = _port_abstract(arch)
    want = ref_per_layer(*ref_abstract(arch))
    assert set(shapes) == set(want)
    for path, t in shapes.items():
        shape, _dtype, ref_axes = want[path]
        assert tuple(t.shape) == shape, path
        assert axes[path] == ref_axes, path
        assert t.device.type == "meta"


def test_meta_build_of_deepseek_v3_allocates_nothing():
    shapes, axes = _port_abstract("deepseek-v3-671b")
    assert sum(t.numel() for t in shapes.values()) > 6.7e11
    assert all(t.device.type == "meta" for t in shapes.values())
    # 256 routed experts stacked on one leading "expert" axis
    we = [p for p in shapes if p.endswith("ffn.we_gate")]
    assert we and all(shapes[p].shape[0] == 256 for p in we)
    assert all(axes[p] == ("expert", "embed", "mlp") for p in we)


def test_axes_leave_a_real_build_bitwise_unchanged():
    cfg = get_config("qwen3-8b", smoke=True)
    gen_a = torch.Generator().manual_seed(3)
    gen_b = torch.Generator().manual_seed(3)
    a = build_model(cfg, generator=gen_a, device="cpu")
    b = build_model(cfg, generator=gen_b, device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert set(param_axes(a)) == set(sa)


def test_make_param_axes_and_meta():
    gen = torch.Generator().manual_seed(0)
    p = make_param((4, 6), gen, axes=("embed", "mlp"))
    assert p.axes == ("embed", "mlp") and p.device.type == "cpu"
    assert make_param((3,), gen).axes == (None,)
    with pytest.raises(ValueError, match="axes"):
        make_param((4, 6), gen, axes=("embed",))
    m = make_param((1 << 20, 1 << 20), meta_generator(), axes=(None, None))
    assert m.device.type == "meta" and m.shape == (1 << 20, 1 << 20)


def test_shape_table_equals_the_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, spec in SHAPES.items():
        ref = REF_SHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    from repro.configs import applicable as ref_applicable
    from repro.configs import skip_reason as ref_skip_reason

    assert applicable(cfg, shape) == ref_applicable(ref_cfg, shape)
    assert skip_reason(cfg, shape) == ref_skip_reason(ref_cfg, shape)
    if not applicable(cfg, shape):
        with pytest.raises(ValueError, match="sub-quadratic"):
            input_specs(cfg, shape)
        return
    kind, kw = input_specs(cfg, shape)
    ref_kind, ref_kw = ref_input_specs(ref_cfg, shape)
    assert kind == ref_kind and set(kw) == set(ref_kw)
    if "exit_idx" in kw:
        assert kw["exit_idx"] == ref_kw["exit_idx"]
    for key in kw:
        if key == "exit_idx":
            continue
        got = {p: (tuple(t.shape), torch_dtype_name(t.dtype))
               for p, t in tree_leaves(kw[key])}
        assert all(t.device.type == "meta" for _, t in tree_leaves(kw[key]))
        assert got == ref_leaves(ref_kw[key]), key


@pytest.mark.parametrize("exit_idx", [0, 1])
def test_input_specs_at_an_early_exit(exit_idx):
    cfg, ref_cfg = get_config("jamba-v0.1-52b"), ref_get_config(
        "jamba-v0.1-52b")
    _, kw = input_specs(cfg, "long_500k", exit_idx=exit_idx)
    _, ref_kw = ref_input_specs(ref_cfg, "long_500k", exit_idx=exit_idx)
    got = {p: (tuple(t.shape), torch_dtype_name(t.dtype))
           for p, t in tree_leaves(kw["cache"])}
    assert got == ref_leaves(ref_kw["cache"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch,
                                                           ref_abstract):
    ref = ref_dryrun()
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shapes, _ = _port_abstract(arch)
    ref_shapes, _ = ref_abstract(arch)
    assert _active_params(cfg, shapes) == ref._active_params(ref_cfg,
                                                             ref_shapes)
    for name, spec in SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            assert _model_flops(cfg, shapes, kind, spec) == ref._model_flops(
                ref_cfg, ref_shapes, kind, REF_SHAPES[name])
