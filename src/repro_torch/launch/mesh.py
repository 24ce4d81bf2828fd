"""Production mesh construction — the port of the reference's
``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module starts no
process group and touches no device (torch's distributed modules are
imported inside them, as the reference imports ``jax`` there).

Topology (the reference's production target):
    single-pod : (16, 16)    axes ("data", "model")        = 256 devices
    multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 devices

A ``DeviceMesh`` needs a process group of at least that world size.  The
reference's dry run forces 512 placeholder host devices; here one
process stands in for all of them through torch's ``"fake"`` backend
(``fake_process_group``), whose collectives move nothing and over which
DTensors of ``meta`` tensors propagate their placements.  Real
collectives run over ``gloo`` processes on the CPU, or ``nccl`` on the
cards.
"""
from __future__ import annotations

import contextlib
import math

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _device_type() -> str:
    import torch
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" and \
        torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over the initialised process
    group's first ranks.  Raises ``RuntimeError`` where no group of at
    least that size is initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need a process group of {n} ranks, have "
            f"{have if have else 'none'}; run the dry run under "
            f"repro_torch.launch.mesh.fake_process_group({n}) (one process "
            "standing in for every device), or start "
            "torch.distributed.init_process_group with world_size="
            f"{n}")
    if have != n:
        raise RuntimeError(
            f"the process group has {have} ranks; the production mesh "
            f"spans exactly {n}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1):
    """A ``("data", "model")`` mesh over the initialised process group (the
    visible cards under ``nccl``, the CPU world under ``gloo`` or
    ``fake``): ``world // model_axis`` data ranks by ``model_axis``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialised process group: "
            "torch.distributed.init_process_group('nccl' or 'gloo', "
            "init_method='tcp://localhost:<port>', rank=r, world_size=n)")
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world}")
    return init_device_mesh(_device_type(), (world // model_axis,
                                             model_axis),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks in this one
    process (rank 0), destroyed on exit: the stand-in for the reference's
    placeholder devices.  The group is global to the process, so this
    refuses to start where one is already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake group would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
