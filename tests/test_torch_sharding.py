"""The port's sharding rules against the JAX reference on the CPU: the
rule presets, ``sanitize_spec`` / ``spec_for_param`` on every parameter of
the ten FULL configs under every preset on both production meshes, the
local shape of the port's ``DTensor`` placements against the reference's
``NamedSharding``, the per-device static bytes, the batch and cache specs
of every decode cell, the optimizer-state shardings (AdamW, Adafactor) and
``abstract_opt_state``, and the cases of ``tests/test_runtime.py::
TestShardingRules``.

The reference's functions run on ``jax.sharding.AbstractMesh`` (they read
``mesh.shape``; no 256 devices are needed). The port's placements are
checked on its production ``DeviceMesh`` (a fake process group, released
after the module).
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.distributed import sharding as RS
from repro.models import build_model as ref_build_model
from repro.optim import Adafactor as RefAdafactor
from repro.optim import AdamW as RefAdamW
from repro.runtime import trainer as RT

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.configs import input_specs
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import (
    make_production_mesh,
    release_mesh,
)
from repro_torch.models import build_model
from repro_torch.models.common import abstract_params
from repro_torch.optim import Adafactor, AdamW
from repro_torch.runtime.trainer import abstract_opt_state, opt_state_shardings

from torch_dist import _leaves, ref_per_layer

torch.set_num_threads(1)

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
PRESETS = {
    "train": (S.train_rules, RS.train_rules),
    "train-dp": (lambda mp: S.train_rules(mp, fsdp=False),
                 lambda mp: RS.train_rules(mp, fsdp=False)),
    "pure-dp": (S.train_rules_pure_dp, RS.train_rules_pure_dp),
    "serve": (S.serve_rules, RS.serve_rules),
    "ep-wide": (S.serve_rules_ep_wide, RS.serve_rules_ep_wide),
}


def ref_mesh(multi_pod):
    shape, axes = MESHES[multi_pod]
    return AbstractMesh(shape, axes)


def stand_in(multi_pod):
    shape, axes = MESHES[multi_pod]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


@pytest.fixture(scope="module")
def abstracts():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_config(arch)
            port = abstract_params(lambda dev: build_model(cfg, device=dev))
            ref = ref_build_model(ref_get_config(arch)).abstract(
                jax.random.key(0))
            cache[arch] = port, ref
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def production():
    meshes = {}

    def get(multi_pod):
        if multi_pod not in meshes:
            release_mesh()
            meshes.clear()
            meshes[multi_pod] = make_production_mesh(multi_pod=multi_pod)
        return meshes[multi_pod]
    yield get
    release_mesh()


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_presets_equal_the_reference(preset, multi_pod):
    port, ref = (f(multi_pod) for f in PRESETS[preset])
    assert port.name == ref.name
    assert port.rules == ref.rules
    assert port.batch_axes == ref.batch_axes
    assert port.seq_axes == ref.seq_axes


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_local_shapes_and_static_bytes(arch, multi_pod,
                                                   abstracts):
    (shapes, axes), (ref_shapes, ref_axes) = abstracts(arch)
    per_layer = ref_per_layer(ref_shapes, ref_axes)
    mesh, rmesh = stand_in(multi_pod), ref_mesh(multi_pod)
    flat_rs = dict(_leaves(ref_shapes))
    for preset, (port_rules, ref_rules) in PRESETS.items():
        rules, rrules = port_rules(multi_pod), ref_rules(multi_pod)
        sh = S.param_shardings(shapes, axes, rules, mesh)
        for path, t in shapes.items():
            shape, _, ax = per_layer[path]
            want = RS.spec_for_param(shape, ax, rrules, rmesh)
            assert sh[path].spec == tuple(want), (preset, path)
            assert S.local_shape(t.shape, sh[path].spec, mesh) == tuple(
                jax.sharding.NamedSharding(rmesh, want).shard_shape(shape))
        # per-device static bytes of the whole parameter tree, in the
        # reference's stacked layout and the port's per-layer one
        rsh = RS.param_shardings(ref_shapes, ref_axes, rrules, rmesh)
        want_bytes = ref_static_bytes(ref_shapes, rsh, rmesh)
        # the reference's abstract params are float32 (its masters)
        f32 = {k: torch.empty(t.shape, dtype=torch.float32, device="meta")
               for k, t in shapes.items()}
        assert S.bytes_per_device(f32, sh) == want_bytes, preset
        assert len(flat_rs) <= len(shapes)


def ref_static_bytes(tree, shardings, mesh):
    # repro/launch/dryrun.py::_tree_bytes_per_device, whose module sets
    # XLA_FLAGS on import (see torch_dist.ref_dryrun)
    from torch_dist import ref_dryrun
    return ref_dryrun()._tree_bytes_per_device(tree, shardings, mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_give_the_references_local_shapes(multi_pod, production):
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = production(multi_pod)
    rmesh = ref_mesh(multi_pod)
    axes = MESHES[multi_pod][1]
    cases = [((4096, 151936), ("model", None)), ((256, 4096), (axes[:-1],)),
             ((256, 7168, 2048), (("data", "model"), None, None)),
             ((512, 64, 32), (axes, None, None)),
             ((64, 128, 8, 128), (None, "data", "model", None))]
    for shape, spec in cases:
        spec = S.sanitize_spec(shape, spec, mesh)
        assert spec == tuple(RS.sanitize_spec(shape, P(*spec), rmesh))
        local, _ = compute_local_shape_and_global_offset(
            shape, mesh, S.placements(spec, mesh))
        want = jax.sharding.NamedSharding(rmesh, P(*spec)).shard_shape(shape)
        assert tuple(local) == tuple(want) == S.local_shape(shape, spec, mesh)
        t = torch.empty(shape, device="meta")
        dt = S.NamedSharding(mesh, spec).shard_meta(t)
        assert tuple(dt.shape) == shape and tuple(dt.to_local().shape) == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, multi_pod):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mesh, rmesh = stand_in(multi_pod), ref_mesh(multi_pod)
    for shape in SHAPES:
        if not applicable(cfg, shape):
            continue
        kind, kw = input_specs(cfg, shape)
        _, rkw = ref_input_specs(rcfg, shape)
        for rules, rrules in ((S.serve_rules(multi_pod),
                               RS.serve_rules(multi_pod)),
                              (S.train_rules(multi_pod),
                               RS.train_rules(multi_pod))):
            if kind == "decode":
                got = S.cache_shardings(kw["cache"], rules, mesh)
                want = RS.cache_shardings(rkw["cache"], rrules, rmesh)
                tok = S.batch_shardings(kw["token"], rules, mesh)
                rtok = RS.batch_shardings(rkw["token"], rrules, rmesh)
                assert tok.spec == tuple(rtok.spec)
            else:
                got = S.batch_shardings(kw["batch"], rules, mesh)
                want = RS.batch_shardings(rkw["batch"], rrules, rmesh)
            got = {p: sh.spec for p, sh in S.tree_leaves(got)}
            want = {p: tuple(sh.spec) for p, sh in _leaves(want)}
            assert got == want, (shape, rules.name)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "rwkv6-1.6b"])
def test_opt_state_shardings_equal_the_reference(arch, opt, multi_pod):
    """The port's optimizer-state shardings, leaf by leaf, against the
    reference's on the reference's own tree, whose block parameters are
    stacked over their segment's layers (a stacked leaf's spec without its
    layers axis for each of the port's per-layer leaves)."""
    cfg = get_config(arch, smoke=True)
    shapes, axes = abstract_params(lambda dev: build_model(cfg, device=dev))
    shapes = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
              for k, v in shapes.items()}
    port_opt = AdamW() if opt == "adamw" else Adafactor()
    ref_opt = RefAdamW() if opt == "adamw" else RefAdafactor()
    mesh, rmesh = stand_in(multi_pod), ref_mesh(multi_pod)
    rules, rrules = S.train_rules(multi_pod), RS.train_rules(multi_pod)

    ref_shapes, ref_axes = ref_build_model(
        ref_get_config(arch, smoke=True)).abstract(jax.random.key(0))
    ref_shapes = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), ref_shapes)
    ref_state = dict(_leaves(RT.abstract_opt_state(ref_opt, ref_shapes)))
    ref_sh = dict(_leaves(RT.opt_state_shardings(ref_opt, ref_shapes,
                                                 ref_axes, rrules, rmesh)))
    want_shape, want_spec = {}, {}
    for path, s in ref_state.items():
        spec = tuple(ref_sh[path].spec)
        parts = path.split(".")
        if len(parts) > 2 and parts[1] in ("segments", "encoder"):
            head = 3 if parts[1] == "segments" else 2
            for layer in range(s.shape[0]):
                p = ".".join(parts[:head] + [str(layer)] + parts[head:])
                want_shape[p], want_spec[p] = tuple(s.shape[1:]), spec[1:]
        else:
            want_shape[path], want_spec[path] = tuple(s.shape), spec

    state = abstract_opt_state(port_opt, shapes)
    assert {p: tuple(t.shape) for p, t in S.tree_leaves(state)} == want_shape
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for _, t in S.tree_leaves(state))
    port_sh = opt_state_shardings(port_opt, shapes, axes, rules, mesh)
    assert {p: sh.spec for p, sh in S.tree_leaves(port_sh)} == want_spec


def test_abstract_opt_state_of_real_values_allocates_nothing():
    values = {"w": torch.zeros(256, 512), "b": torch.zeros(32)}
    state = abstract_opt_state(Adafactor(), values)
    assert {p: tuple(t.shape) for p, t in S.tree_leaves(state)} == {
        "v.w.vr": (256,), "v.w.vc": (512,), "v.b.v": (32,)}
    assert all(t.device.type == "meta" for _, t in S.tree_leaves(state))


def test_replicated_and_shard_count():
    mesh = stand_in(True)
    tree = {"a": torch.empty(4, device="meta"),
            "b": [torch.empty(2, 2, device="meta")]}
    rep = S.replicated(tree, mesh)
    assert rep["a"].spec == () and rep["b"][0].spec == ()
    assert S.shard_count((("pod", "data"), "model"), mesh) == 512
    assert S.shard_count((None, None), mesh) == 1


# -- the cases of tests/test_runtime.py::TestShardingRules --------------------


def _mesh(**axes):
    return types.SimpleNamespace(shape=dict(axes))


def test_sanitize_drops_nondivisible():
    mesh = _mesh(model=1)
    # 7 not divisible by any >1 axis; with axis size 1 everything divides
    assert S.sanitize_spec((7,), ("model",), mesh) == ("model",)
    assert S.sanitize_spec((7,), ("model",), _mesh(model=16)) == (None,)


def test_sanitize_no_duplicate_axes():
    mesh = _mesh(data=1, model=1)
    # second use of "model" dropped
    assert S.sanitize_spec((4, 4), ("model", "model"), mesh) == (
        "model", None)


def test_train_rules_fsdp_embed():
    r = S.train_rules()
    assert r.axis_for("embed") == ("data",)
    assert r.axis_for("heads") == "model"
    assert r.axis_for("layers") is None


def test_serve_rules_replicate_embed():
    r = S.serve_rules()
    assert r.axis_for("embed") is None
    assert r.seq_axes == "model"


def test_ep_wide_shards_experts_everywhere():
    r = S.serve_rules_ep_wide()
    assert r.axis_for("expert") == ("data", "model")


def test_spec_for_param():
    mesh = _mesh(data=1, model=1)
    spec = S.spec_for_param((64, 128), ("embed", "heads"), S.train_rules(),
                            mesh)
    assert spec == ("data", "model")
