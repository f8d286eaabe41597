"""Device meshes of the port (reference ``src/repro/launch/mesh.py``).

Functions, not module-level constants: importing this module never touches
a process group.

* ``make_production_mesh`` gives the reference's production layouts, the
  ``(16, 16)`` ``("data", "model")`` mesh and the ``(2, 16, 16)``
  ``("pod", "data", "model")`` multi-pod mesh, as a torch ``DeviceMesh``
  over a shape-only process group: torch's ``fake`` backend, whose
  collectives move nothing and return outputs of the right shapes. This
  process is rank 0 of 256 (512); the dry-run (``launch/dryrun.py``)
  evaluates rank 0's share of every sharded program on ``meta`` tensors.
* ``make_host_mesh`` is a ``(data, model)`` mesh over the real ranks of
  this job: gloo on the CPU, NCCL on the card, with a one-rank process
  group when none is initialised.

A torch ``DeviceMesh`` hangs on the default process group, so one process
holds one of the two at a time: ``release_mesh`` ends the group that a
mesh of this module opened, before the other kind is built.

The roofline constants are the NVIDIA H100 SXM5's (one card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# H100 SXM5 per-card figures used by the roofline analysis:
# dense bfloat16 tensor-core peak, 989.4 TFLOP/s without sparsity (NVIDIA H100
# Tensor Core GPU datasheet, SXM5 column; 1979 TFLOP/s is with sparsity)
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth, 3.35 TB/s (same datasheet, H100 SXM5 80 GB)
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s bidirectional per GPU over 18 links, i.e. 450 GB/s in
# each direction (same datasheet; NVIDIA Hopper architecture whitepaper)
LINK_BW = 450e9

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over a fake process group of 256
    (multi-pod: 512) ranks, opened here when no process group is; an open
    fake group of that size is reused, any other group raises."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is open; the production "
                f"mesh needs the fake backend over {world} ranks "
                f"(release_mesh() ends a group this module opened)")
    else:
        # importing FakeStore registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device: DeviceLike = None):
    """A ``(data, model)`` mesh over the ranks of this job (tests,
    examples): the default process group's ranks, or a one-rank group
    (gloo on the CPU, NCCL on the card) opened here when there is none.
    ``device`` is the card unless the caller passes ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() == "fake":
        raise RuntimeError("the fake process group of a production mesh is "
                           "open; release_mesh() first")
    n = dist.get_world_size()
    assert n % model_axis == 0
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def release_mesh() -> None:
    """End the default process group (the one a mesh of this module hangs
    on), where one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS_BF16", "make_host_mesh",
           "make_production_mesh", "release_mesh"]
