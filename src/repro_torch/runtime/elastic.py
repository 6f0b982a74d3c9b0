"""Elastic rescale: rebuild a training job on another set of ranks by
re-sharding its checkpoint, the paper's live migration applied to training
jobs; the port of `repro.runtime.elastic` on `torch.distributed`.

Flow: pause -> checkpoint (or reuse the latest one) -> build the new mesh
over the surviving or assigned ranks -> derive new placements from the SAME
rule table -> `restore(..., placements=new)` (each rank reads every leaf on
the host and keeps its shard) -> resume at the recorded step with the
step-indexed data pipeline.  The global batch stays the same; each rank's
part grows when the job shrinks.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over ranks of the
default process group, which the caller starts
(`torch.distributed.init_process_group`, ``nccl`` for a CUDA mesh and
``gloo`` for a CPU one; `init_process_group` below picks by device type).
Building a mesh is collective over the whole world: every rank takes part,
also one that the mesh leaves out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ckpt import latest_checkpoint, read_extra, restore
from ..models import ModelConfig
from ..parallel.sharding import ShardingStrategy, default_strategy, layouts, state_specs
from ..train import Optimizer, state_shapes

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The process-group backend of a device type: ``nccl`` for CUDA,
    ``gloo`` for the CPU."""
    if device_type not in BACKENDS:
        raise ValueError(f"no process-group backend for device type {device_type!r}")
    return BACKENDS[device_type]


def init_process_group(device_type: str, init_method: str, rank: int, world_size: int):
    """`torch.distributed.init_process_group` with the device type's backend."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(device_type), init_method=init_method, rank=rank,
                            world_size=world_size)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Device-mesh blueprint: an axis shape and axis names, without bound
    ranks.  A job's plan survives across migrations and rescales: `build`
    binds it to whatever ranks the new home offers, and `resize_mesh_plan`
    re-derives the shape when the count changes."""

    shape: Tuple[int, ...]          # e.g. (4, 2) = 4-way data x 2-way model
    axis_names: Tuple[str, ...]     # e.g. ("data", "model")

    @property
    def n_devices(self) -> int:
        """Ranks the plan occupies (product of the axis sizes)."""
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    def build(self, devices=None, device_type: str = "cuda"):
        """Bind the plan to ranks of the default process group (default:
        all of them, in order), as a DeviceMesh of ``device_type``.  Raises
        when there is no process group, when its backend is not the device
        type's, or when fewer than ``n_devices`` ranks are given; ranks
        beyond the plan are left out.  Every rank of the world must call
        it (creating a group is collective)."""
        from torch.distributed.device_mesh import DeviceMesh

        backend = backend_for(device_type)
        n = self.n_devices
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"MeshPlan.build needs a process group of at least {n} ranks: "
                f"torch.distributed.init_process_group({backend!r}, ...) first")
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {device_type} mesh needs the {backend!r} backend; the "
                               f"process group runs {dist.get_backend()!r}")
        ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
        if len(ranks) < n:
            raise ValueError(f"need {n} devices, have {len(ranks)}")
        grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(self.shape)
        return DeviceMesh(device_type, grid, mesh_dim_names=tuple(self.axis_names))


def resize_mesh_plan(plan: MeshPlan, n_devices: int) -> MeshPlan:
    """Largest same-axis-structure mesh on at most ``n_devices``: only the
    leading (data-parallel) axis is resized, so every parameter placement
    built from the plan's rule table stays valid."""
    inner = plan.n_devices // plan.shape[0]       # model-parallel block size
    new_lead = int(n_devices) // inner
    if new_lead < 1:
        raise ValueError(
            f"not enough devices for even one model replica: have "
            f"{n_devices}, need {inner} per replica")
    return MeshPlan((new_lead,) + tuple(plan.shape[1:]), plan.axis_names)


def degrade_mesh_plan(plan: MeshPlan, n_lost: int) -> MeshPlan:
    """`resize_mesh_plan` phrased as a failure: the largest mesh after
    losing ``n_lost`` of the plan's devices."""
    return resize_mesh_plan(plan, plan.n_devices - n_lost)


def reshard_restore(
    ckpt_dir: str,
    cfg: ModelConfig,
    optimizer: Optimizer,
    new_mesh,
    strategy: Optional[ShardingStrategy] = None,
) -> Tuple[Optional[Dict], int, ShardingStrategy]:
    """Restore the latest committed checkpoint under ``ckpt_dir`` onto
    ``new_mesh``: `state_shapes(cfg, optimizer)` gives the state's shapes,
    `state_specs` applies the same rule table to the new mesh, and
    `ckpt.restore` puts each leaf into those placements.  Returns
    ``(state, step, strategy)`` with ``step`` the one recorded at save
    time; ``state`` is None on a rank the mesh leaves out.  Raises
    `FileNotFoundError` when no committed checkpoint exists."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    strategy = strategy or default_strategy(new_mesh)
    step = int(read_extra(path).get("step", 0))
    if new_mesh.get_coordinate() is None:
        return None, step, strategy
    shapes = state_shapes(cfg, optimizer)
    where = layouts(state_specs(shapes, new_mesh, strategy), new_mesh)
    return restore(path, shapes, placements=where), step, strategy


class ElasticSupervisor:
    """Ties the failure detector to the rescale path: on a rescale, compute
    the degraded mesh plan, reshard-restore, and hand (state, step, mesh,
    strategy) back to the caller to rebuild its train step."""

    def __init__(self, ckpt_dir: str, cfg: ModelConfig, optimizer: Optimizer,
                 mesh_plan: MeshPlan, devices=None, device_type: str = "cuda"):
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg
        self.optimizer = optimizer
        self.mesh_plan = mesh_plan
        self.device_type = device_type
        self.devices = list(devices if devices is not None
                            else range(dist.get_world_size()))
        self.rescales: List[Tuple[int, Tuple[int, ...]]] = []

    def rescale(self, n_lost_devices: int):
        """Shrink the job onto the surviving ranks (the first of
        ``devices``): degrade the mesh plan, build the new mesh (every rank
        of the world calls this), reshard-restore the latest checkpoint onto
        it, and return ``(state, step, mesh, strategy)``."""
        new_plan = degrade_mesh_plan(self.mesh_plan, n_lost_devices)
        survivors = self.devices[: new_plan.n_devices]
        mesh = new_plan.build(survivors, self.device_type)
        state, step, strat = reshard_restore(self.ckpt_dir, self.cfg, self.optimizer, mesh)
        self.mesh_plan = new_plan
        self.devices = survivors
        self.rescales.append((step, new_plan.shape))
        return state, step, mesh, strat
