"""Training loop: the port of `repro.train.trainer`, on one device.

`Trainer.run` draws step-indexed batches, moves them to the device, runs
the train step and logs each step's loss, gradient norm and seconds.  It
runs on ``device="cuda"`` unless asked otherwise.  With ``ckpt_dir`` it
saves the train state every ``ckpt_every`` steps and at the end, in the
reference's checkpoint format, and `init_or_restore` resumes from the
newest committed checkpoint, written by either package: a job moves
between a JAX host and this port by checkpoint and resume.

With ``mesh`` (a `torch.distributed.device_mesh.DeviceMesh`, e.g.
`runtime.elastic.MeshPlan.build`) the job trains sharded: the state is
DTensors placed by `parallel.sharding.state_specs` under ``strategy`` (by
default `default_strategy(mesh)`), each step runs on the rank's part of the
batch (`train_step.make_train_step`'s sharded step), checkpoints hold whole
arrays (every rank gathers, one writes) and `init_or_restore` restores
into this mesh's placements, whatever mesh the checkpoint was saved from.
Every rank of the mesh runs the same `Trainer`.  The device is the mesh's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..ckpt import CheckpointManager
from ..data import DataConfig, SyntheticLM
from ..models import ModelConfig
from ..parallel.comm import mesh_device
from ..parallel.sharding import (ShardingStrategy, default_strategy, distribute_tree, layouts,
                                 state_specs)
from .optimizer import Optimizer, make_optimizer
from .train_step import init_state, make_train_step, state_shapes


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    loss_chunk: int = 0
    n_microbatch: int = 1
    seed: int = 0


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        data: Iterable,
        mesh=None,
        strategy: Optional[ShardingStrategy] = None,
        optimizer: Optional[Optimizer] = None,
        step_hooks: Optional[List[Callable]] = None,
        device="cuda",
    ):
        from torch.distributed.device_mesh import DeviceMesh

        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not "
                            f"{type(mesh).__name__}")
        if strategy is not None and mesh is None:
            raise ValueError("a sharding strategy needs a mesh")
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data
        self.mesh = mesh
        self.strategy = (strategy or default_strategy(mesh)) if mesh is not None else None
        self.device = mesh_device(mesh) if mesh is not None else torch.device(device)
        # Without an optimizer, a schedule that fits the run length (a fixed
        # 100-step warm-up would swallow short runs), as the reference makes.
        self.optimizer = optimizer or make_optimizer(
            cfg.optimizer, lr=1e-3, warmup=max(1, tcfg.steps // 10), total_steps=tcfg.steps)
        self.step_hooks = step_hooks or []
        self.metrics_log: List[Dict] = []
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
                     if tcfg.ckpt_dir else None)
        self._step = make_train_step(cfg, self.optimizer, loss_chunk=tcfg.loss_chunk,
                                     n_microbatch=tcfg.n_microbatch, mesh=mesh,
                                     strategy=self.strategy)

    def _specs(self):
        return state_specs(state_shapes(self.cfg, self.optimizer), self.mesh, self.strategy)

    def init_or_restore(self):
        """Resume from the newest committed checkpoint in ``ckpt_dir``
        (restored onto the device, or into the mesh's placements, at the
        step its ``extra`` names), or fresh parameters from ``tcfg.seed``
        (made whole on every rank of a mesh, which keeps its shards)."""
        if self.ckpt is not None:
            where = layouts(self._specs(), self.mesh) if self.mesh is not None else None
            restored = self.ckpt.restore_latest(state_shapes(self.cfg, self.optimizer),
                                                device=self.device, placements=where)
            if restored is not None:
                state, extra = restored
                return state, int(extra.get("step", 0))
        generator = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        state = init_state(generator, self.cfg, self.optimizer, device=self.device)
        if self.mesh is not None:
            state = distribute_tree(state, self._specs(), self.mesh)
        return state, 0

    def run(self, state=None, start_step: int = 0):
        if state is None:
            state, start_step = self.init_or_restore()
        # Step-indexed sources seek to the resume point; plain iterables
        # restart from their head.
        seekable = hasattr(self.data, "batch_at")
        data_it = None if seekable else iter(self.data)
        for step in range(start_step, self.tcfg.steps):
            batch = self.data.batch_at(step) if seekable else next(data_it)
            t0 = time.perf_counter()
            state, metrics = self._step(state, _to_device(batch, self.device))
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            rec = {"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                   "dt_s": dt}
            self.metrics_log.append(rec)
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d}  loss {loss:.4f}  {dt*1e3:.0f} ms")
            for hook in self.step_hooks:
                hook(self, step, state, rec)
            if (self.ckpt is not None and step > 0
                    and step % self.tcfg.ckpt_every == 0):
                self.ckpt.save_async(step, state, {"step": step + 1})
        if self.ckpt is not None:
            self.ckpt.save_async(self.tcfg.steps, state, {"step": self.tcfg.steps})
            self.ckpt.wait()
        return state


def make_synthetic_trainer(cfg: ModelConfig, tcfg: TrainerConfig,
                           global_batch: int, seq_len: int, **kw) -> Trainer:
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  global_batch=global_batch, seq_len=seq_len,
                                  seed=tcfg.seed))
    return Trainer(cfg, tcfg, data, **kw)
