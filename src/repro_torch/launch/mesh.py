"""Production mesh construction; the port of `repro.launch.mesh`.

A function (not a module constant) so importing never touches
`torch.distributed`.  Single-pod: 256 H100s as ("data", "model") =
(32, 8); multi-pod: 512 as ("pod", "data", "model") = (2, 32, 8).  The
"model" axis is one 8-GPU NVLink node; "data" and "pod" cross the
network.

Where the process belongs to no process group of that size, the mesh is
built over a one-process *fake* group (`torch.distributed`'s ``"fake"``
backend over a `FakeStore`): this process is rank 0 of the whole world,
every collective returns at once without moving data, and a step of
tensors on the ``meta`` device runs through the port's own code as rank 0
would run it.  The fake group stays open after the call: `close_fake_group`
destroys it, and a later call for another world size closes the old one
first, so a caller may build the single-pod and the multi-pod mesh in
turn.  A real group of another size is never touched: that raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.distributed as dist

_FAKE = {"open": False}


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def open_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake group of ``world`` ranks (see the
    module's docstring); reuses an open fake group of that size."""
    if dist.is_initialized():
        if dist.get_world_size() == world and (_FAKE["open"] or dist.get_backend() == "fake"):
            return
        if not _FAKE["open"]:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is open; "
                               f"a mesh of {world} needs its own")
        close_fake_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _FAKE["open"] = True


def close_fake_group() -> None:
    """Destroy the fake group that `open_fake_group` opened, if any."""
    if _FAKE["open"]:
        _FAKE["open"] = False
        if dist.is_initialized():
            dist.destroy_process_group()


def fake_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``cpu`` DeviceMesh of ``shape`` over the whole world of a fake
    group (opened here if need be), this process its rank 0."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= int(s)
    open_fake_group(n)
    return init_device_mesh("cpu", tuple(int(s) for s in shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The (32, 8) or (2, 32, 8) mesh over the current process group when it
    has that many ranks, else over a fake group (see the module's
    docstring)."""
    shape, names = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized() and not _FAKE["open"] and dist.get_world_size() == n:
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(_device_type(), shape, mesh_dim_names=names)
    return fake_mesh(shape, names)


def make_host_mesh(model: int = 1, data: int = 0):
    """A small ("data", "model") mesh over the current process group (its
    world of ``data`` x ``model`` ranks; ``data`` 0 takes the rest) for
    tests and small programs."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data == 0:
        data = n // model
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"
