"""Elastic execution bridge: every scheduled migration runs (or is
faithfully simulated) as checkpoint → reshard → resume; the port of
`repro.fleet.elastic_bridge`, on `torch.distributed`.

The planning layers (`fleet.policies`, `fleet.planner`) emit `Move`s; the
`MigrationExecutor` ledger turns each move into a `Transfer` occupying link
bandwidth over simulated time.  Before this bridge, that transfer was an
abstract blob of ``state_mb=64.0`` megabytes — the numbers meant nothing
physical.  The bridge gives the executor a pluggable **backend seam** that
maps every transfer onto the `runtime.elastic` flow:

  snapshot   pause/stream the job's state into a `ckpt` checkpoint
             (`ElasticBackend.snapshot` → `SnapshotInfo`: payload bytes,
             shard-file count, host-side serialize time)
  transfer   the checkpoint bytes cross the move's links — the executor
             ledger still owns fair-share contention, but the byte count
             now comes from the snapshot, not a flat constant
  restore    rebuild the job's `MeshPlan` over the destination's devices
             (`resize_mesh_plan` keeps model-parallel axes intact) and
             `reshard_restore` the checkpoint onto the new mesh, resuming
             at the recorded step

Backends:

* `FlatStateBackend` — the pre-bridge model, kept as an explicit object:
  every app ships ``state_mb`` MB, snapshot/restore are free.  Parity
  tests pin the simulated backend against it.
* `SimulatedElasticBackend` — derives transfer size and snapshot/restore
  phase times from *declared* checkpoint byte counts
  (`AppProfile.state_mb`, or an attached model via `train.state_shapes` +
  `ckpt.tree_nbytes`) and the `ckpt` shard layout (`shard_count`).  Apps
  with no declared state keep the flat fallback with zero host phases, so
  the paper scenarios' fleet fingerprints are bit-identical to
  `FlatStateBackend` — the bridge changes what the numbers *mean*, not
  what happens, until a job declares real state.
* `LiveElasticBackend` — the real thing, used when a CUDA card is
  present: `ckpt.save` on snapshot, `reshard_restore` onto the rebuilt
  mesh (ranks of the default process group) on restore, source-checkpoint
  re-install on rollback.  Drives `chip_smoke.py`'s live move on the card
  and the multi-rank tests on ``gloo``.

Rollback contract: when a destination dies mid-copy the executor calls
`ElasticBackend.rollback` — the source checkpoint taken at transfer start
is re-installed (live: reshard-restored onto the source mesh; simulated:
bookkept) and the job keeps/resumes running where it was.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from repro_torch.core.apps import PlacementRequest
from repro_torch.core.migration import Move

if TYPE_CHECKING:  # torch-importing modules are deferred to call sites so the
    from repro_torch.runtime.elastic import MeshPlan  # pure simulator stays light

MODE_PRECOPY = "precopy"
MODE_STOP_AND_COPY = "stop_and_copy"

#: Fraction of the copy a pre-copy migration replays as its final
#: dirty-page round (the only pause the source-side user sees).
DIRTY_PAGE_FRACTION = 0.05


def pipeline_downtime(mode: str, snapshot_s: float, transfer_s: float,
                      restore_s: float) -> float:
    """User-visible pause of one completed pipeline, by mode: pre-copy
    streams the snapshot and copy while the source keeps serving, pausing
    only for one dirty-page round plus the restore cutover; stop-and-copy
    pauses for the whole snapshot → copy → restore.  The one formula both
    the executor's records and `execute_move` use."""
    if mode == MODE_PRECOPY:
        return DIRTY_PAGE_FRACTION * transfer_s + restore_s
    return snapshot_s + transfer_s + restore_s


@dataclasses.dataclass(frozen=True)
class SnapshotInfo:
    """One taken snapshot: what the wire must carry and what the host paid.

    ``snapshot_s`` / ``restore_s`` are the host-side serialize and
    device_put phases (simulated: deterministic from byte count and shard
    layout; live: measured wall clock).  ``restore_s`` is the *estimate*
    the executor schedules with — `ElasticBackend.restore` returns the
    realized value."""

    req_id: int
    nbytes: int                 # checkpoint payload bytes
    mbits: float                # what the transfer occupies on the links
    n_shards: int               # ckpt shard files (restore opens each)
    snapshot_s: float
    restore_s: float
    path: Optional[str] = None  # live backend: the on-disk checkpoint
    mesh_shape: Optional[Tuple[int, ...]] = None  # source mesh at snapshot
    # Serving-workload state strategy ("drain" | "replay" | "kv-ship") the
    # backend chose for this snapshot; None for non-serving apps.  Threaded
    # by the executor onto the resulting `MigrationRecord`.
    strategy: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MigrationPhases:
    """Per-phase timing of one executed migration (the quantities that
    flow into `fleet.telemetry.MigrationRecord` and BENCH_fleet.json)."""

    mode: str                   # MODE_PRECOPY | MODE_STOP_AND_COPY
    snapshot_s: float
    transfer_s: float
    restore_s: float
    downtime_s: float           # user-visible pause (mode-dependent subset)
    mbits: float

    @property
    def duration_s(self) -> float:
        return self.snapshot_s + self.transfer_s + self.restore_s


def _device_budget(move: Optional[Move], target_n: int) -> int:
    """Devices the move's destination can offer a mesh rebuild.

    Node capacity denominates *schedulable devices* on the fleets where
    mesh plans live (`core.cluster.build_fleet_topology`: capacity =
    chips), so it clamps the job's target size.  Sub-unit capacities
    (fractional FPGA shares, and any other non-count unit < 1) don't
    denominate devices — the job keeps its target size instead of
    crashing the resize with a zero-device mesh."""
    if move is None:
        return target_n
    cap = float(move.new.node.capacity)
    if cap < 1.0:
        return target_n
    return min(target_n, int(cap))


class ElasticBackend:
    """Seam between the migration ledger and the elastic-training runtime.

    The executor calls, in order: `snapshot` when a transfer starts (the
    byte count sizes the copy), `restore` when it completes (mesh rebuild
    + reshard-restore at the destination), `rollback` when the destination
    dies mid-copy (re-install the source checkpoint), and `release` when
    the app departs mid-migration.  `transfer_mbits` is the shared size
    model — `InstantExecutor` prices its schedules through the same
    method, so the two executors cannot drift."""

    name = "abstract"

    def transfer_mbits(self, request: PlacementRequest, move: Move) -> float:
        """Megabits a migration of ``request`` along ``move`` would copy."""
        raise NotImplementedError

    def predict_phases(self, request: PlacementRequest,
                       move: Optional[Move] = None) -> Tuple[float, float, float]:
        """Pure prediction of ``(mbits, snapshot_s, restore_s)`` for a
        hypothetical migration of ``request`` — what `snapshot` would
        report, **without** taking one (no registry mutation, no state
        retained).  The planner's cost model and the runtime's
        calibration ledger price moves through this, so planning can
        never perturb the executor's bookkeeping."""
        return (self.transfer_mbits(request, move), 0.0, 0.0)

    def snapshot(self, request: PlacementRequest, move: Move,
                 now: float) -> SnapshotInfo:
        """Checkpoint the job's state; returns what the wire must carry."""
        raise NotImplementedError

    def restore(self, request: PlacementRequest, move: Move,
                snap: SnapshotInfo, now: float) -> float:
        """Rebuild the mesh at the destination and reshard-restore the
        snapshot; returns the realized restore time in seconds."""
        raise NotImplementedError

    def rollback(self, request: PlacementRequest, move: Move,
                 snap: SnapshotInfo, now: float) -> None:
        """Destination failed mid-copy: re-install the source checkpoint
        so the job keeps/resumes running where it was."""
        raise NotImplementedError

    def release(self, req_id: int) -> None:
        """The app departed mid-migration; drop any retained snapshot."""


class FlatStateBackend(ElasticBackend):
    """The pre-bridge transfer model as an explicit backend: every app
    ships a flat ``state_mb`` MB, snapshot and restore are instantaneous.
    Kept so the simulated backend's fallback behavior can be pinned
    against it (fingerprint parity) and for callers that want the legacy
    semantics on purpose."""

    name = "flat"

    def __init__(self, state_mb: float = 64.0):
        self.state_mb = state_mb

    def transfer_mbits(self, request: PlacementRequest, move: Move) -> float:
        return self.state_mb * 8.0

    def snapshot(self, request: PlacementRequest, move: Move,
                 now: float) -> SnapshotInfo:
        return SnapshotInfo(
            req_id=request.req_id, nbytes=int(self.state_mb * 1e6),
            mbits=self.state_mb * 8.0, n_shards=1,
            snapshot_s=0.0, restore_s=0.0)

    def restore(self, request, move, snap, now) -> float:
        return 0.0

    def rollback(self, request, move, snap, now) -> None:
        pass


class SimulatedElasticBackend(ElasticBackend):
    """Faithful simulation of the checkpoint → reshard → resume pipeline.

    Transfer size comes from the job's *checkpoint byte count* — either an
    attached model (`attach_job(cfg=..., optimizer=...)` sizes the exact
    `train.state_shapes` tree through `ckpt.tree_nbytes`), explicit
    ``state_bytes``, or the app profile's declared ``state_mb``.  Host
    phase times follow the `ckpt` format: serialize/device_put at
    ``host_gbps`` plus ``per_shard_s`` per shard file (`ckpt.shard_count`
    of the payload), charged on both the snapshot and the restore side.

    Apps with no declared state fall back to ``default_state_mb`` with
    zero host phases — byte-identical to `FlatStateBackend`, which is what
    keeps the paper scenarios' fleet fingerprints unchanged.

    Mesh bookkeeping: a job attached with a `MeshPlan` gets its plan
    rebuilt on every restore via `resize_mesh_plan` toward the job's
    *attached* device count, clamped to the destination node's capacity —
    so a move onto a small slice shrinks the mesh and a later move back
    onto a big one grows it again (the hetero-expansion resize path) —
    and `mesh_plans[req_id]` always holds the job's current plan."""

    name = "simulated"

    def __init__(self, default_state_mb: float = 64.0,
                 host_gbps: float = 16.0, per_shard_s: float = 0.01):
        self.default_state_mb = default_state_mb
        self.host_gbps = host_gbps       # host-side serialize/device_put rate
        self.per_shard_s = per_shard_s   # per shard-file open/flush overhead
        self.mesh_plans: Dict[int, "MeshPlan"] = {}
        self.snapshots: Dict[int, SnapshotInfo] = {}
        # (req_id, dest_node_id, from_shape, to_shape) per completed restore
        self.restores: List[Tuple[int, Optional[str],
                                  Optional[Tuple[int, ...]],
                                  Optional[Tuple[int, ...]]]] = []
        self.rollbacks: List[int] = []
        self._job_bytes: Dict[int, int] = {}
        self._target_n: Dict[int, int] = {}   # attached (full-size) devices

    # ------------------------------------------------------------- registry
    def attach_job(self, req_id: int, *, state_bytes: Optional[int] = None,
                   cfg: Any = None, optimizer: Any = None,
                   mesh_plan: Optional[MeshPlan] = None) -> None:
        """Declare a training job behind ``req_id``: its checkpoint size
        (explicit bytes, or computed from the model's state tree) and
        optionally its device-mesh plan (rebuilt on every migration)."""
        if state_bytes is None and cfg is not None:
            from repro_torch.ckpt import tree_nbytes      # deferred: pulls in torch
            from repro_torch.train import state_shapes
            state_bytes = tree_nbytes(state_shapes(cfg, optimizer))
        if state_bytes is not None:
            self._job_bytes[req_id] = int(state_bytes)
        if mesh_plan is not None:
            self.mesh_plans[req_id] = mesh_plan
            self._target_n[req_id] = mesh_plan.n_devices

    def _state_nbytes(self, request: PlacementRequest) -> Optional[int]:
        nb = self._job_bytes.get(request.req_id)
        if nb is not None:
            return nb
        if request.app.state_mb is not None:
            return int(request.app.state_mb * 1e6)
        return None

    def _host_s(self, nbytes: int, n_shards: int) -> float:
        return nbytes * 8.0 / 1e9 / self.host_gbps + n_shards * self.per_shard_s

    # -------------------------------------------------------------- backend
    def transfer_mbits(self, request: PlacementRequest, move: Move) -> float:
        nb = self._state_nbytes(request)
        return self.default_state_mb * 8.0 if nb is None else nb * 8.0 / 1e6

    def predict_phases(self, request: PlacementRequest,
                       move: Optional[Move] = None) -> Tuple[float, float, float]:
        """Exactly the numbers `snapshot` would produce — same byte count,
        shard layout, and host-phase model — but read-only (nothing lands
        in ``snapshots``)."""
        nb = self._state_nbytes(request)
        if nb is None:
            return (self.default_state_mb * 8.0, 0.0, 0.0)
        from repro_torch.ckpt import shard_count          # deferred: pulls in torch
        host = self._host_s(nb, shard_count(nb))
        return (nb * 8.0 / 1e6, host, host)

    def snapshot(self, request: PlacementRequest, move: Move,
                 now: float) -> SnapshotInfo:
        nb = self._state_nbytes(request)
        plan = self.mesh_plans.get(request.req_id)
        shape = plan.shape if plan is not None else None
        if nb is None:   # no declared state: legacy flat semantics
            snap = SnapshotInfo(
                req_id=request.req_id, nbytes=int(self.default_state_mb * 1e6),
                mbits=self.default_state_mb * 8.0, n_shards=1,
                snapshot_s=0.0, restore_s=0.0, mesh_shape=shape)
        else:
            from repro_torch.ckpt import shard_count      # deferred: pulls in torch
            shards = shard_count(nb)
            host = self._host_s(nb, shards)
            snap = SnapshotInfo(
                req_id=request.req_id, nbytes=nb, mbits=nb * 8.0 / 1e6,
                n_shards=shards, snapshot_s=host, restore_s=host,
                mesh_shape=shape)
        self.snapshots[request.req_id] = snap
        return snap

    def restore(self, request: PlacementRequest, move: Move,
                snap: SnapshotInfo, now: float) -> float:
        plan = self.mesh_plans.get(request.req_id)
        dest = move.new.node.node_id if move is not None else None
        if plan is None:
            self.restores.append((request.req_id, dest, None, None))
        else:
            from repro_torch.runtime.elastic import resize_mesh_plan
            # Resize toward the job's attached device count (so a move back
            # onto a big slice grows the mesh again), clamped to what the
            # destination offers.
            target = self._target_n.get(request.req_id, plan.n_devices)
            new_plan = resize_mesh_plan(plan, _device_budget(move, target))
            self.mesh_plans[request.req_id] = new_plan
            self.restores.append((request.req_id, dest, plan.shape, new_plan.shape))
        return snap.restore_s

    def rollback(self, request: PlacementRequest, move: Move,
                 snap: SnapshotInfo, now: float) -> None:
        # The snapshot taken at transfer start IS the source checkpoint —
        # it stays registered so the job resumes from it; the mesh plan
        # never changed (restore is what rebuilds it).
        self.rollbacks.append(request.req_id)

    def release(self, req_id: int) -> None:
        self.snapshots.pop(req_id, None)
        self._job_bytes.pop(req_id, None)
        self.mesh_plans.pop(req_id, None)
        self._target_n.pop(req_id, None)


# ------------------------------------------------------------- live backend
@dataclasses.dataclass
class LiveJob:
    """A real training job the live backend can checkpoint and rebuild."""

    ckpt_dir: str
    cfg: Any                    # ModelConfig
    optimizer: Any              # train.Optimizer
    plan: MeshPlan
    devices: Optional[list] = None   # ranks; default: the whole default process group
    state: Any = None           # live state to snapshot (None: reuse latest ckpt)
    step: int = 0
    device_type: str = "cuda"   # the mesh's device type ("cpu": gloo ranks)


@dataclasses.dataclass
class ResumedJob:
    """What a restore hands back: everything needed to re-jit and resume."""

    state: Any
    step: int
    mesh: Any
    strategy: Any
    plan: MeshPlan


class LiveElasticBackend(ElasticBackend):
    """Execute migrations for real: `ckpt.save` on snapshot,
    `reshard_restore` onto the rebuilt destination mesh on restore,
    source-checkpoint re-install on rollback.  Phase times are measured
    wall clock (this backend runs *outside* the deterministic simulator —
    the demo and the live smoke drive it through `execute_move`).

    After a restore/rollback, ``resumed[req_id]`` holds the
    (state, step, mesh, strategy) the caller rebuilds its jitted step
    around."""

    name = "live"

    def __init__(self):
        self.jobs: Dict[int, LiveJob] = {}
        self.resumed: Dict[int, ResumedJob] = {}

    def register_job(self, req_id: int, ckpt_dir: str, cfg: Any,
                     optimizer: Any, mesh_plan: MeshPlan,
                     devices: Optional[list] = None,
                     device_type: str = "cuda") -> LiveJob:
        job = LiveJob(ckpt_dir, cfg, optimizer, mesh_plan, devices=devices,
                      device_type=device_type)
        self.jobs[req_id] = job
        return job

    def update_state(self, req_id: int, state: Any, step: int) -> None:
        """Hand the backend the job's live state so `snapshot` can save it
        (otherwise snapshot reuses the latest committed checkpoint)."""
        job = self.jobs[req_id]
        job.state, job.step = state, step

    def _devices(self, job: LiveJob) -> list:
        if job.devices is not None:
            return list(job.devices)
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("LiveElasticBackend binds meshes to ranks of the default "
                               "process group: torch.distributed.init_process_group "
                               "first")
        return list(range(dist.get_world_size()))

    def transfer_mbits(self, request: PlacementRequest, move: Move) -> float:
        from repro_torch.ckpt import checkpoint_nbytes, latest_checkpoint
        job = self.jobs.get(request.req_id)
        if job is not None:
            path = latest_checkpoint(job.ckpt_dir)
            if path is not None:
                nb, _ = checkpoint_nbytes(path)
                return nb * 8.0 / 1e6
        if request.app.state_mb is not None:
            return request.app.state_mb * 8.0
        return 64.0 * 8.0

    def snapshot(self, request: PlacementRequest, move: Move,
                 now: float) -> SnapshotInfo:
        from repro_torch.ckpt import checkpoint_nbytes, latest_checkpoint, save
        job = self.jobs[request.req_id]
        t0 = time.perf_counter()
        if job.state is not None:
            path = save(job.ckpt_dir, job.step, job.state,
                        extra={"step": job.step})
        else:
            path = latest_checkpoint(job.ckpt_dir)
            if path is None:
                raise FileNotFoundError(
                    f"job {request.req_id}: no live state and no committed "
                    f"checkpoint under {job.ckpt_dir}")
        snapshot_s = time.perf_counter() - t0
        nbytes, shards = checkpoint_nbytes(path)
        return SnapshotInfo(
            req_id=request.req_id, nbytes=nbytes, mbits=nbytes * 8.0 / 1e6,
            n_shards=shards, snapshot_s=snapshot_s, restore_s=0.0,
            path=path, mesh_shape=job.plan.shape)

    def _reshard(self, job: LiveJob, plan: MeshPlan) -> Tuple[ResumedJob, float]:
        from repro_torch.runtime.elastic import reshard_restore
        t0 = time.perf_counter()
        devices = self._devices(job)
        mesh = plan.build(devices, job.device_type)
        state, step, strat = reshard_restore(job.ckpt_dir, job.cfg,
                                             job.optimizer, mesh)
        job.state, job.step = state, step
        return ResumedJob(state, step, mesh, strat, plan), time.perf_counter() - t0

    def restore(self, request: PlacementRequest, move: Move,
                snap: SnapshotInfo, now: float) -> float:
        from repro_torch.runtime.elastic import resize_mesh_plan
        job = self.jobs[request.req_id]
        n_dev = _device_budget(move, len(self._devices(job)))
        new_plan = resize_mesh_plan(job.plan, n_dev)
        resumed, restore_s = self._reshard(job, new_plan)
        job.plan = new_plan
        self.resumed[request.req_id] = resumed
        return restore_s

    def rollback(self, request: PlacementRequest, move: Move,
                 snap: SnapshotInfo, now: float) -> None:
        """Destination died: reshard-restore the source checkpoint onto the
        (unchanged) source mesh plan so the job resumes where it was."""
        job = self.jobs[request.req_id]
        self.resumed[request.req_id], _ = self._reshard(job, job.plan)

    def release(self, req_id: int) -> None:
        self.jobs.pop(req_id, None)
        self.resumed.pop(req_id, None)


# ------------------------------------------------------------ one-shot path
def execute_move(backend: ElasticBackend, request: PlacementRequest,
                 move: Move, now: float = 0.0,
                 mode: str = MODE_STOP_AND_COPY) -> MigrationPhases:
    """Run one move through the full pipeline synchronously and return its
    per-phase timings — the demo/one-job path (the fleet runtime instead
    drives the same backend through the `MigrationExecutor` event loop,
    which adds fair-share link contention).

    The transfer phase is priced over the slowest link of the move's
    old∪new path (uncontended); snapshot/restore come from the backend
    (live: measured, simulated: derived from the byte count)."""
    snap = backend.snapshot(request, move, now)
    links = {l.link_id: l.bandwidth_mbps for l in move.old.links}
    links.update({l.link_id: l.bandwidth_mbps for l in move.new.links})
    bw = min(links.values(), default=100.0)
    transfer_s = snap.mbits / bw
    restore_s = backend.restore(request, move, snap,
                                now + snap.snapshot_s + transfer_s)
    downtime = pipeline_downtime(mode, snap.snapshot_s, transfer_s, restore_s)
    return MigrationPhases(mode=mode, snapshot_s=snap.snapshot_s,
                           transfer_s=transfer_s, restore_s=restore_s,
                           downtime_s=downtime, mbits=snap.mbits)


def auto_backend(state_mb: float = 64.0) -> ElasticBackend:
    """`LiveElasticBackend` when a CUDA card is usable (real deployments),
    `SimulatedElasticBackend` otherwise (headless sims)."""
    import torch
    if torch.cuda.is_available():
        return LiveElasticBackend()
    return SimulatedElasticBackend(default_state_mb=state_mb)
