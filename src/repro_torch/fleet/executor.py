"""Link-capacity reservation ledger driving every scheduled migration
through the elastic checkpoint → reshard → resume pipeline.

An accepted reconfiguration plan is a *set* of moves; executing it costs
real network time, and since the time-model refactor that time is simulated
rather than merely reported.  The `MigrationExecutor` is a ledger of active
transfers over the topology's links, and since the elastic-bridge refactor
each transfer is one trip through the `fleet.elastic_bridge` backend seam:

* when a transfer **starts**, the backend takes a **snapshot** of the job's
  state (`ElasticBackend.snapshot`) — the checkpoint's byte count sizes the
  copy (no more flat ``state_mb`` blob for jobs that declare state) and the
  host-side serialize time opens the transfer's phase timeline;
* an accepted move starts as a **pre-copy** transfer when its destination
  currently fits — the source stays occupied until the transfer finishes,
  so the app is *double-booked* over the transfer window;
* moves whose destination is full wait; whenever a transfer completes, the
  freed capacity is offered to the waiting queue.  A stalled cycle (e.g.
  two apps swapping full nodes) is broken by **suspending** the best
  waiting app (stop-and-copy: its source occupancy is released and the app
  takes downtime for the full snapshot→copy→restore pipeline);
* concurrent transfers sharing a link get a **fair share** of its
  bandwidth — each transfer's rate is ``min over its links of
  bandwidth / n_active_on_link`` — so contention slows transfers down
  instead of pre-serializing them.  Whenever the active set changes, every
  transfer's remaining phases are re-projected and a fresh
  `MigrationComplete` generation is scheduled; stale completions are
  ignored;
* each active transfer **reserves** ``reserve_mbps`` of bandwidth on every
  link it crosses (clamped to the residual) against the engine's admission
  control — a saturating migration can reject an arrival it would
  previously have admitted, coupling migration cost to admission;
* when a transfer **completes**, the backend **restores** at the
  destination (`ElasticBackend.restore`: mesh rebuild + reshard-restore,
  with its own host-side phase time) and the engine commits the move;
* a **destination node failure** aborts the transfers headed there: the
  backend **rolls back** (`ElasticBackend.rollback` re-installs the source
  checkpoint), a pre-copy move resumes on its source, a suspended app must
  be re-placed by the runtime (or is lost).  A **link cut**
  (`on_link_failure`) aborts every transfer crossing the dead link the
  same way, with source rollback for pre-copy moves.

Per-phase timings (snapshot_s / transfer_s / restore_s / downtime_s) land
on every `MigrationRecord` and flow into BENCH_fleet.json — see
docs/elastic.md for the pipeline and docs/fleet.md for the ledger.

The old executor's instantaneous semantics survive as `InstantExecutor`
for the synchronous `FleetScheduler` path (`core.cluster`); it prices its
schedules through the SAME backend size model, so the two executors cannot
drift apart on transfer sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.migration import MigrationStep, Move, plan_and_apply
from repro_torch.core.placement import (
    STATE_MIGRATING,
    STATE_PLACED,
    PlacementEngine,
)
from repro_torch.core.reconfig import ReconfigResult

from .elastic_bridge import (
    MODE_PRECOPY,
    MODE_STOP_AND_COPY,
    ElasticBackend,
    SimulatedElasticBackend,
    SnapshotInfo,
    pipeline_downtime,
)
from .events import EventQueue, MigrationComplete, MigrationStart
from .telemetry import MigrationRecord, TransferMeasurement


# --------------------------------------------------------------- transfers
@dataclasses.dataclass
class Transfer:
    """One in-flight checkpoint copy walking the snapshot → transfer →
    restore phase timeline over sim time.

    Lifecycle: created by `MigrationExecutor._start` (after the backend's
    snapshot), progressed by `_advance` (snapshot phase first, then link
    copy at the fair-share rate, then restore phase), finished by
    `on_complete` (backend restore + engine commit) or killed by
    `on_node_failure` / `on_link_failure` / `cancel` (backend rollback /
    release + engine abort)."""

    move: Move
    mode: str                       # MODE_PRECOPY | MODE_STOP_AND_COPY
    links: Tuple[str, ...]          # link ids the copy traverses
    snapshot: SnapshotInfo          # what the backend checkpointed
    snap_remaining_s: float         # host serialize phase still to run
    mbits_remaining: float          # link copy still to run
    restore_remaining_s: float      # host restore phase still to run
    started_s: float
    last_update_s: float
    rate_mbps: float = 0.0
    gen: int = -1                   # matches the live MigrationComplete
    # Per-link bandwidth debited against the engine's admission control
    # while this transfer runs (released on commit/abort/cancel).
    reserved: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Interned `links` indexes (engine.intern_links), resolved once per
    # transfer: the fair-share ledger re-debits the same path on every
    # contention change, so the per-link id lookups are hoisted out.
    link_idx: Optional[Tuple[int, ...]] = None

    @property
    def req_id(self) -> int:
        return self.move.req_id

    def phases_spent(self, duration_s: float) -> Tuple[float, float, float]:
        """(snapshot_s, transfer_s, restore_s) actually elapsed so far —
        exact for finished transfers, partial for aborted ones."""
        snap = self.snapshot.snapshot_s - self.snap_remaining_s
        restore = self.snapshot.restore_s - self.restore_remaining_s
        return snap, max(duration_s - snap - restore, 0.0), restore


def _transfer_links(move: Move) -> Tuple[str, ...]:
    """Links the copy occupies: old path (drain) ∪ new path (fill)."""
    ids = {l.link_id for l in move.old.links}
    ids |= {l.link_id for l in move.new.links}
    return tuple(sorted(ids))


class MigrationExecutor:
    """Reservation ledger driving accepted plans through simulated time.

    The runtime owns the event loop; the executor mutates the engine's
    migration state (`begin_move` / `commit_move` / `abort_move` /
    `suspend`), delegates the snapshot / restore / rollback phases to its
    `ElasticBackend`, and schedules its own `MigrationComplete` events.
    """

    def __init__(self, state_mb: float = 64.0, reserve_mbps: float = 2.0,
                 backend: Optional[ElasticBackend] = None):
        self.state_mb = state_mb
        # The elastic bridge: sizes every transfer and runs its snapshot /
        # restore / rollback phases.  Default: simulated backend whose
        # no-declared-state fallback reproduces the old flat model.
        self.backend = backend if backend is not None else (
            SimulatedElasticBackend(default_state_mb=state_mb))
        # Bandwidth each active transfer debits against admission control
        # on every link it crosses (clamped to the residual).  0 restores
        # the old unreserved semantics.
        self.reserve_mbps = reserve_mbps
        self.active: Dict[int, Transfer] = {}
        self.waiting: List[Move] = []        # accepted, not yet transferring
        self.records: List[MigrationRecord] = []
        # Measured transfer facts, index-aligned with ``records`` — the
        # "actual" side of the calibration join (obs.calibration).
        self.measurements: List[TransferMeasurement] = []
        self.moves_dropped = 0               # accepted moves never executed
        self._gen = 0

    # ------------------------------------------------------------- queries
    @property
    def n_inflight(self) -> int:
        """Apps mid-migration: transferring or suspended-waiting."""
        return len(self.active) + len(self.waiting)

    def link_shares(self) -> Dict[str, int]:
        """Active transfer count per link (the contention the ledger bills)."""
        counts: Dict[str, int] = {}
        for tr in self.active.values():
            for lid in tr.links:
                counts[lid] = counts.get(lid, 0) + 1
        return counts

    def _measure(self, engine: PlacementEngine,
                 tr: Transfer) -> TransferMeasurement:
        """Freeze one retiring transfer's measured facts, appended
        index-aligned with its `MigrationRecord`."""
        links = engine.topo.links
        uncont = min((links[lid].bandwidth_mbps
                      for lid in tr.links if lid in links), default=100.0)
        return TransferMeasurement(
            req_id=tr.req_id, mbits=tr.snapshot.mbits,
            nbytes=tr.snapshot.nbytes, n_shards=tr.snapshot.n_shards,
            links=tr.links, uncontended_mbps=uncont)

    # ------------------------------------------------------------ plan API
    def begin(
        self,
        engine: PlacementEngine,
        result: ReconfigResult,
        now: float,
        events: EventQueue,
    ) -> int:
        """Admit an accepted plan's moves into the ledger; returns how many
        transfers started immediately (the rest wait for capacity)."""
        if not result.accepted or not result.moves:
            return 0
        self._advance(now)   # bank progress before contention changes rates
        before = len(self.active)
        for mv in sorted(result.moves, key=lambda m: (m.ratio, m.req_id)):
            if engine.is_migrating(mv.req_id):   # defensive; windows skip these
                self.moves_dropped += 1
                continue
            self.waiting.append(mv)
            engine.placed[mv.req_id].state = STATE_MIGRATING
        self._pump(engine, now, events)
        return len(self.active) - before

    # --------------------------------------------------------- event hooks
    def on_complete(
        self,
        engine: PlacementEngine,
        req_id: int,
        gen: int,
        now: float,
        events: EventQueue,
    ) -> Optional[MigrationRecord]:
        """Handle a `MigrationComplete`; returns the record, or None when
        the event is stale (superseded by a contention re-projection).

        This is the pipeline's final phase: the engine commits the move and
        the backend restores at the destination (mesh rebuild +
        reshard-restore from the snapshot taken at start)."""
        tr = self.active.get(req_id)
        if tr is None or tr.gen != gen:
            return None
        self._advance(now)
        del self.active[req_id]
        engine.release_link_bandwidth(tr.reserved)
        engine.commit_move(req_id)
        request = engine.placed[req_id].request
        self.backend.restore(request, tr.move, tr.snapshot, now)
        duration = now - tr.started_s
        snap_s, transfer_s, restore_s = tr.phases_spent(duration)
        downtime = pipeline_downtime(tr.mode, snap_s, transfer_s, restore_s)
        rec = MigrationRecord(req_id, tr.mode, "completed",
                              tr.started_s, now, downtime,
                              snapshot_s=snap_s, transfer_s=transfer_s,
                              restore_s=restore_s,
                              strategy=tr.snapshot.strategy)
        self.records.append(rec)
        self.measurements.append(self._measure(engine, tr))
        self._reschedule(engine, now, events)
        self._pump(engine, now, events)
        return rec

    def _abort_active(self, engine: PlacementEngine, tr: Transfer,
                      now: float) -> None:
        """Shared abort path: release reservations, roll the engine and the
        elastic backend back (source checkpoint re-install), record."""
        engine.release_link_bandwidth(tr.reserved)
        engine.abort_move(tr.req_id)
        if tr.req_id in engine.placed:
            self.backend.rollback(engine.placed[tr.req_id].request,
                                  tr.move, tr.snapshot, now)
        # A suspended (stop-and-copy) app served nothing for the whole
        # transfer; a pre-copy app kept running on its source.
        duration = now - tr.started_s
        down = duration if tr.mode == MODE_STOP_AND_COPY else 0.0
        snap_s, transfer_s, restore_s = tr.phases_spent(duration)
        self.records.append(MigrationRecord(
            tr.req_id, tr.mode, "aborted", tr.started_s, now, down,
            snapshot_s=snap_s, transfer_s=transfer_s, restore_s=restore_s,
            strategy=tr.snapshot.strategy))
        self.measurements.append(self._measure(engine, tr))

    def on_node_failure(
        self,
        engine: PlacementEngine,
        node_id: str,
        now: float,
        events: EventQueue,
    ) -> Tuple[List[int], List[int]]:
        """Abort migrations touching a failed node.

        Returns ``(rolled_back, homeless)``: apps whose pre-copy transfer
        to/through the node was aborted (the backend re-installs their
        source checkpoint and they keep running on their source), and
        suspended apps whose destination died mid-copy (the runtime must
        re-place or drop them — their snapshot is the only live copy)."""
        self._advance(now)
        rolled_back: List[int] = []
        homeless: List[int] = []
        for req_id in sorted(self.active):
            tr = self.active[req_id]
            dest = tr.move.new.node.node_id
            src = tr.move.old.node.node_id
            if dest != node_id and src != node_id:
                continue
            del self.active[req_id]
            self._abort_active(engine, tr, now)
            if req_id in engine.suspended:
                homeless.append(req_id)
            elif src != node_id:
                rolled_back.append(req_id)
            # src == node_id: the app rolls back onto a dead source — the
            # runtime's normal eviction pass (`apps_on_node`) picks it up.
        for mv in list(self.waiting):
            if node_id in (mv.new.node.node_id, mv.old.node.node_id):
                self.waiting.remove(mv)
                self._resolve_waiting_drop(engine, mv, homeless)
        self._reschedule(engine, now, events)
        self._pump(engine, now, events)
        return rolled_back, homeless

    def on_link_failure(
        self,
        engine: PlacementEngine,
        link_id: str,
        now: float,
        events: EventQueue,
    ) -> Tuple[List[int], List[int]]:
        """Abort transfers crossing a cut link (the uplink-cut analogue of
        `on_node_failure`).

        Returns ``(rolled_back, homeless)``: pre-copy transfers roll back
        to their source (which may itself now be unreachable — the
        runtime's `apps_on_link` eviction pass picks those up), suspended
        apps must be re-placed or dropped by the runtime."""
        self._advance(now)
        rolled_back: List[int] = []
        homeless: List[int] = []
        for req_id in sorted(self.active):
            tr = self.active[req_id]
            if link_id not in tr.links:
                continue
            del self.active[req_id]
            self._abort_active(engine, tr, now)
            if req_id in engine.suspended:
                homeless.append(req_id)
            else:
                rolled_back.append(req_id)
        for mv in list(self.waiting):
            if link_id in _transfer_links(mv):
                self.waiting.remove(mv)
                self._resolve_waiting_drop(engine, mv, homeless)
        self._reschedule(engine, now, events)
        self._pump(engine, now, events)
        return rolled_back, homeless

    def cancel(self, engine: PlacementEngine, req_id: int, now: float,
               events: EventQueue) -> bool:
        """Withdraw ``req_id`` from the ledger (departure mid-migration).
        The caller releases the engine side; the backend drops whatever
        snapshot it retained for the app."""
        tr = self.active.get(req_id)
        touched = tr is not None
        if tr is not None:
            self._advance(now)   # bank phases BEFORE removing the transfer
            del self.active[req_id]
            engine.release_link_bandwidth(tr.reserved)
            duration = now - tr.started_s
            down = duration if tr.mode == MODE_STOP_AND_COPY else 0.0
            snap_s, transfer_s, restore_s = tr.phases_spent(duration)
            self.records.append(MigrationRecord(
                req_id, tr.mode, "cancelled", tr.started_s, now, down,
                snapshot_s=snap_s, transfer_s=transfer_s,
                restore_s=restore_s, strategy=tr.snapshot.strategy))
            self.measurements.append(self._measure(engine, tr))
        for mv in list(self.waiting):
            if mv.req_id == req_id:
                self.waiting.remove(mv)
                self.moves_dropped += 1   # accepted but never transferred
                touched = True
        if touched:
            self.backend.release(req_id)
        if tr is not None:
            self._reschedule(engine, now, events)
            self._pump(engine, now, events)
        return touched

    def on_capacity_freed(self, engine: PlacementEngine, now: float,
                          events: EventQueue) -> None:
        """Offer freed capacity (departures, recoveries) to waiting moves."""
        if self.waiting:
            self._advance(now)
            self._pump(engine, now, events)

    # ------------------------------------------------------------ internals
    def _resolve_waiting_drop(self, engine: PlacementEngine, mv: Move,
                              homeless: List[int]) -> None:
        """A waiting move was dropped; restore its app's state."""
        self.moves_dropped += 1
        if mv.req_id not in engine.placed:
            return
        if mv.req_id in engine.suspended:
            if not engine.resume_at_source(mv.req_id):
                homeless.append(mv.req_id)
        else:
            engine.placed[mv.req_id].state = STATE_PLACED

    def _advance(self, now: float) -> None:
        """Progress every active transfer to ``now`` along its phase
        timeline: finish the snapshot phase, then drain megabits at the
        current fair-share rate, then burn down the restore phase."""
        for tr in self.active.values():
            dt = now - tr.last_update_s
            if dt > 0.0:
                take = min(dt, tr.snap_remaining_s)
                tr.snap_remaining_s -= take
                dt -= take
                if dt > 0.0 and tr.mbits_remaining > 0.0 and tr.rate_mbps > 0.0:
                    drain = tr.mbits_remaining / tr.rate_mbps
                    if dt >= drain:   # drained: compare times, not the
                        tr.mbits_remaining = 0.0   # float-residual subtraction
                        dt -= drain
                    else:
                        tr.mbits_remaining -= tr.rate_mbps * dt
                        dt = 0.0
                if dt > 0.0 and tr.mbits_remaining <= 0.0:
                    tr.restore_remaining_s = max(tr.restore_remaining_s - dt, 0.0)
            tr.last_update_s = now

    def _reschedule(self, engine: PlacementEngine, now: float,
                    events: EventQueue) -> None:
        """Recompute fair-share rates and re-project completions under a
        fresh generation (stale `MigrationComplete`s become no-ops).  A
        completion lands after the remaining snapshot + copy + restore.

        Reservations are NOT touched here: `_pump` — which every public
        path ends in — owns them (release on entry, re-debit each
        transfer's live fair-share rate on exit)."""
        counts = self.link_shares()
        links = engine.topo.links
        for req_id in sorted(self.active):
            tr = self.active[req_id]
            tr.rate_mbps = min(
                (links[lid].bandwidth_mbps / counts[lid] for lid in tr.links),
                default=100.0,
            )
            self._gen += 1
            tr.gen = self._gen
            eta = (now + tr.snap_remaining_s
                   + tr.mbits_remaining / max(tr.rate_mbps, 1e-9)
                   + tr.restore_remaining_s)
            events.push(eta, MigrationComplete(req_id, tr.gen))

    def _start(self, engine: PlacementEngine, mv: Move, mode: str, now: float,
               events: EventQueue) -> None:
        request = engine.placed[mv.req_id].request
        snap = self.backend.snapshot(request, mv, now)
        tr = Transfer(
            move=mv,
            mode=mode,
            links=_transfer_links(mv),
            snapshot=snap,
            snap_remaining_s=snap.snapshot_s,
            mbits_remaining=snap.mbits,
            restore_remaining_s=snap.restore_s,
            started_s=now,
            last_update_s=now,
        )
        # No reservation here: every start path runs `_reschedule` before
        # control returns (the `_pump` progressed branch), which debits the
        # transfer's live fair-share rate — `reserve_mbps > 0` is the
        # enable flag, the flat amount itself is no longer used.
        self.active[mv.req_id] = tr
        events.push(now, MigrationStart(mv.req_id, mode))

    def _stale(self, engine: PlacementEngine, mv: Move) -> bool:
        """A waiting move is stale once its app departed or was re-homed
        (failure eviction / drift readmission) away from the move's source."""
        placed = engine.placed.get(mv.req_id)
        if placed is None:
            return True
        if mv.req_id in engine.suspended:
            return False                     # suspended apps sit off-node
        return placed.candidate.node.node_id != mv.old.node.node_id

    def _release_reservations(self, engine: PlacementEngine) -> None:
        for req_id in sorted(self.active):
            tr = self.active[req_id]
            if tr.reserved:
                engine.release_link_bandwidth(tr.reserved)
                tr.reserved = {}

    def _reserve_fair_share(self, engine: PlacementEngine) -> None:
        """Debit each active transfer's *live fair-share rate* (engine-
        clamped to the link residual) on every link it crosses — the
        bandwidth the copy is consuming right now, not a flat constant —
        so admission control for new arrivals sees the real contention.
        Sorted order keeps the ledger deterministic."""
        for req_id in sorted(self.active):
            tr = self.active[req_id]
            if tr.link_idx is None:
                tr.link_idx = engine.intern_links(tr.links)
            tr.reserved = engine.reserve_link_bandwidth(tr.links,
                                                        tr.rate_mbps,
                                                        link_idx=tr.link_idx)

    def _pump(self, engine: PlacementEngine, now: float,
              events: EventQueue) -> None:
        """Start every waiting move that fits; break stalls by suspension.

        Terminates: each iteration either starts a transfer, drops a stale
        move, suspends one app (at most once per app), or exits.

        Owns the bandwidth reservations: they are lifted for the duration
        of the sweep — transfer-vs-transfer contention is already modeled
        by the fair-share ledger itself, so a running copy must not block
        a *migration* admission, only outside arrivals — and re-debited at
        the live fair-share rates on the way out."""
        if self.reserve_mbps > 0.0:
            self._release_reservations(engine)
            try:
                self._pump_loop(engine, now, events)
            finally:
                self._reserve_fair_share(engine)
        else:
            self._pump_loop(engine, now, events)

    def _pump_loop(self, engine: PlacementEngine, now: float,
                   events: EventQueue) -> None:
        while True:
            progressed = False
            for mv in list(self.waiting):
                if self._stale(engine, mv):
                    self.waiting.remove(mv)
                    self.moves_dropped += 1
                    if mv.req_id in engine.placed and not engine.is_migrating(mv.req_id):
                        engine.placed[mv.req_id].state = STATE_PLACED
                    progressed = True
                    continue
                if engine.begin_move(mv.req_id, mv.new):
                    mode = (MODE_STOP_AND_COPY if mv.req_id in engine.suspended
                            else MODE_PRECOPY)
                    self.waiting.remove(mv)
                    self._start(engine, mv, mode, now, events)
                    progressed = True
            if progressed:
                self._reschedule(engine, now, events)
                continue
            if self.active or not self.waiting:
                return
            # Stall with no transfer in flight: a capacity cycle.  Suspend
            # the best not-yet-suspended waiting app (stop-and-copy) to
            # break it; if everything is already suspended, the plan is
            # unexecutable — roll the suspended apps back.
            pending = [mv for mv in self.waiting
                       if mv.req_id not in engine.suspended]
            if pending:
                best = min(pending, key=lambda m: (m.ratio, m.req_id))
                engine.suspend(best.req_id)
                continue
            for mv in list(self.waiting):
                self.waiting.remove(mv)
                self.moves_dropped += 1
                if mv.req_id in engine.placed and not engine.resume_at_source(mv.req_id):
                    engine.drop(mv.req_id)
            return


# ----------------------------------------------------- legacy instant path
@dataclasses.dataclass(frozen=True)
class ScheduledMigration:
    """One step of an `InstantExecutor` schedule: the (already applied)
    migration step plus its priced slot on the per-link serialization
    timeline."""

    step: MigrationStep
    start_s: float
    duration_s: float

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s


@dataclasses.dataclass
class MigrationSchedule:
    """Priced schedule of an instantly-applied plan (`InstantExecutor`):
    transfers serialized per link, with makespan / overlap / downtime
    aggregates.  Purely descriptive — the engine was already mutated."""

    items: List[ScheduledMigration]
    state_mb: float

    @property
    def makespan_s(self) -> float:
        return max((it.end_s for it in self.items), default=0.0)

    @property
    def total_transfer_s(self) -> float:
        return sum(it.duration_s for it in self.items)

    @property
    def overlap_factor(self) -> float:
        """Serial work / makespan; 1.0 = fully serial, >1 = link
        parallelism, 0.0 = nothing migrated."""
        mk = self.makespan_s
        return self.total_transfer_s / mk if mk > 0 else 0.0

    @property
    def total_downtime_s(self) -> float:
        return sum(it.step.est_downtime_s for it in self.items)


def _transfer_time(mbits: float, move: Move) -> float:
    """``mbits`` over the slowest link on the move's path (Mb / Mbps).
    The size comes from the elastic backend — the one size model both
    executors share."""
    links = move.new.links or move.old.links
    bw = min((l.bandwidth_mbps for l in links), default=100.0)
    return mbits / bw


class InstantExecutor:
    """Apply an accepted plan within the calling tick (the pre-refactor
    semantics): moves mutate the engine immediately through the
    live-migration planner and are *priced* on per-link serialization
    timelines without occupying simulated time.  Used by the synchronous
    `FleetScheduler` (`core.cluster`); the fleet runtime uses the
    time-extended `MigrationExecutor`.

    Transfer sizes come from the same `ElasticBackend.transfer_mbits`
    model the time-extended executor snapshots with, so the two executors
    price identical copies identically."""

    def __init__(self, state_mb: float = 64.0,
                 backend: Optional[ElasticBackend] = None):
        self.state_mb = state_mb
        self.backend = backend if backend is not None else (
            SimulatedElasticBackend(default_state_mb=state_mb))

    def execute(self, engine: PlacementEngine, result: ReconfigResult) -> MigrationSchedule:
        if not result.accepted or not result.moves:
            return MigrationSchedule([], self.state_mb)
        requests = {mv.req_id: engine.placed[mv.req_id].request
                    for mv in result.moves}
        mbits_by_req = {mv.req_id: self.backend.transfer_mbits(
                            requests[mv.req_id], mv)
                        for mv in result.moves}
        steps = plan_and_apply(
            engine, result.moves, state_mb=self.state_mb,
            state_mb_by_req={r: m / 8.0 for r, m in mbits_by_req.items()})
        result.migration_steps.extend(steps)
        link_free: Dict[str, float] = {}   # link_id → earliest idle time
        items: List[ScheduledMigration] = []
        for step in steps:
            links = _transfer_links(step.move)
            start = max((link_free.get(l, 0.0) for l in links), default=0.0)
            dur = _transfer_time(mbits_by_req[step.move.req_id], step.move)
            for l in links:
                link_free[l] = start + dur
            items.append(ScheduledMigration(step, start, dur))
        return MigrationSchedule(items, self.state_mb)
