"""The paper's contribution, end to end, on a pod fleet:

  1. build a heterogeneous pod fleet (different $/chip-hour),
  2. admit a stream of training and serving jobs FCFS under SLO and budget
     bounds (Step 5: first-come-first-served fills the cheap pods),
  3. run the in-operation reconfiguration (Step 7): the LP trial-solve
     finds a placement with higher group satisfaction and emits migrations,
  4. EXECUTE one migration for a real (tiny) training job through the
     elastic bridge (`fleet.elastic_bridge.LiveElasticBackend`): snapshot,
     reshard onto a (1, 1) mesh on the card (NCCL; gloo ranks with
     ``--device cpu``), resume, with each phase's seconds,
  5. report the satisfaction ratios (the paper's fig. 5(b) quantity).

    python -m repro_torch.examples.reconfiguration_demo [--device cuda]

The twin of the JAX package's ``examples/reconfiguration_demo.py``.  The
pods' prices and generation are the reference's own figures
(`core.cluster.PodSpec`), kept so that both packages place alike; they
are not an H100's.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.cluster import FleetScheduler, JobSpec, PodSpec, build_fleet_topology
from repro_torch.examples import device_of
from repro_torch.fleet.elastic_bridge import LiveElasticBackend, execute_move
from repro_torch.models import reduced
from repro_torch.runtime.elastic import MeshPlan, init_process_group
from repro_torch.train import make_optimizer
from repro_torch.train.trainer import TrainerConfig, make_synthetic_trainer

PODS = (("tokyo-a", 256, 1.2), ("tokyo-b", 256, 1.2), ("osaka-spot", 256, 0.85),
        ("osaka-v5p", 256, 2.1))


@contextlib.contextmanager
def one_rank_group(device: torch.device, workdir: str):
    """The default process group the live backend binds its meshes to: the
    one already there, or a one-rank group of ``device``'s type (a FileStore
    in ``workdir``) for the length of the block."""
    if dist.is_initialized():
        yield
        return
    init_process_group(device.type, f"file://{Path(workdir) / 'store'}", 0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fleet():
    """Steps 1-3: the pods, the jobs admitted FCFS, jobs 1 and 2 released
    and the reconfiguration trial.  Returns (scheduler, trial, what was
    printed)."""
    pods = [PodSpec(*p) for p in PODS]
    sched = FleetScheduler(build_fleet_topology(pods), reconfig_every=10 ** 9, window=24)
    print("fleet:", ", ".join(f"{p.name}(${p.chip_hour_usd}/chip·h)" for p in pods),
          "(the reference's prices, not an H100's)")
    rng = np.random.default_rng(0)
    admitted = []
    for i in range(14):
        fast = i % 3 == 0
        t = float(rng.uniform(0.8, 2.0))
        job = JobSpec(job_id=i, arch="granite-3-2b", shape="train_4k", chips=64,
                      step_time_s=t, step_slo_s=t + (0.1 if fast else 2.0),
                      budget_usd_month=None if fast else 90_000.0)
        pod = sched.submit(job)
        admitted.append(pod)
        print(f"  job {job.job_id:2d} (slo={job.step_slo_s:.2f}s"
              f"{', budget' if job.budget_usd_month else ''}) → {pod}")
    utilization = sched.utilization()
    print("utilization:", {k: f"{v:.0%}" for k, v in utilization.items()})
    # Two early jobs on the cheap pod complete and release their slices:
    # the first-come-first-served skew the paper targets.
    for done in (1, 2):
        sched.engine.release(done)
    print("jobs 1,2 completed → osaka-spot capacity freed")

    res = sched.recon.plan(sched.engine.recent(24))
    mmr = res.mean_moved_ratio   # None when the trial moves nothing
    print(f"\nreconfig trial: S {res.s_before:.3f} → {res.s_after:.3f} "
          f"(gain {res.gain:.3f}), {res.n_moved} moves, "
          f"mean X+Y of moved = {f'{mmr:.4f}' if mmr is not None else 'n/a'}")
    for mv in res.moves:
        print(f"  move job {mv.req_id}: {mv.old.node.site_id} → "
              f"{mv.new.node.site_id}  (ratio {mv.ratio:.4f})")
    printed = {"pods": [list(p) for p in PODS], "admitted": admitted,
               "utilization": utilization, "s_before": res.s_before, "s_after": res.s_after,
               "gain": res.gain, "n_moved": res.n_moved, "mean_moved_ratio": mmr,
               "moves": [{"job": m.req_id, "source": m.old.node.site_id,
                          "destination": m.new.node.site_id, "ratio": m.ratio}
                         for m in res.moves]}
    return sched, res, printed


def live_move(sched, mv, device: torch.device) -> Dict:
    """Step 4: a tiny granite job trained 6 steps, moved by the live
    backend (snapshot of its state, restore onto a (1, 1) mesh), then 4
    more steps from the restored state."""
    from repro_torch._tree import tree_items
    from repro_torch.parallel.comm import is_dtensor

    req = sched.engine.placed[mv.req_id].request
    print(f"\nexecuting migration of job {mv.req_id} as ckpt→reshard→resume:")
    cfg = reduced(get_config("granite-3-2b"), vocab_size=128)
    opt = make_optimizer("adamw", lr=1e-3)
    with tempfile.TemporaryDirectory() as d, one_rank_group(device, d):
        tcfg = TrainerConfig(steps=6, log_every=2, ckpt_dir=str(Path(d) / "ckpt"),
                             ckpt_every=100)
        trainer = make_synthetic_trainer(cfg, tcfg, global_batch=4, seq_len=32, device=device)
        state = trainer.run()
        # The bridge runs the pipeline the fleet runtime simulates: snapshot
        # (ckpt.save), transfer (priced over the move's links), restore (the
        # destination's mesh rebuilt, `reshard_restore`).
        backend = LiveElasticBackend()
        backend.register_job(mv.req_id, tcfg.ckpt_dir, cfg, opt,
                             MeshPlan((1, 1), ("data", "model")), device_type=device.type)
        backend.update_state(mv.req_id, state, step=6)   # pause
        phases = execute_move(backend, req, mv)
        resumed = backend.resumed[mv.req_id]
        print(f"  phases: snapshot {phases.snapshot_s:.3f}s + "
              f"transfer {phases.transfer_s:.3f}s ({phases.mbits:.0f} Mb) + "
              f"restore {phases.restore_s:.3f}s "
              f"→ downtime {phases.downtime_s:.3f}s")
        print(f"  restored at step {resumed.step} on "
              f"{mv.new.node.site_id} (mesh {resumed.plan.shape}); resuming")
        saved, got = list(tree_items(state)), list(tree_items(resumed.state))
        same = [p for p, _ in saved] == [p for p, _ in got] and all(
            torch.equal((a.full_tensor() if is_dtensor(a) else a).cpu(), b.cpu())
            for (_, a), (_, b) in zip(got, saved))
        tcfg2 = TrainerConfig(steps=10, log_every=2)
        trainer2 = make_synthetic_trainer(cfg, tcfg2, global_batch=4, seq_len=32,
                                          mesh=resumed.mesh, strategy=resumed.strategy)
        trainer2.run(state=resumed.state, start_step=resumed.step)
        backend.release(mv.req_id)
    print(f"  migration complete — no training progress lost (restored bit for bit: {same})")
    return {"job": mv.req_id, "phases": {k: getattr(phases, k) for k in
                                         ("snapshot_s", "transfer_s", "restore_s",
                                          "downtime_s", "mbits")},
            "resumed_at_step": resumed.step, "mesh": list(resumed.plan.shape),
            "restored_bit_for_bit": same,
            "losses_before": [r["loss"] for r in trainer.metrics_log],
            "losses_after": [r["loss"] for r in trainer2.metrics_log]}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    sched, res, out = fleet()
    sched.recon.apply(res)
    if res.moves:
        out["live_move"] = live_move(sched, res.moves[0], device)

    sat = [s.ratio for s in res.satisfaction if s.ratio < 2.0 - 1e-9]
    mean = float(np.mean(sat)) if sat else 2.0
    print(f"\nimproved jobs: {len(sat)}; mean X+Y = {mean:.4f}  (paper fig.5(b): ≈1.96 regime)")
    out.update(improved_jobs=len(sat), mean_improved_ratio=mean,
               ratios=[s.ratio for s in res.satisfaction])
    return out


if __name__ == "__main__":
    main()
