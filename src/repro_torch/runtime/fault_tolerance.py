"""Failure detection & restart policy for multi-pod fleets.
(The port's own copy of `repro.runtime.fault_tolerance`, which imports no JAX:
the port imports nothing of `repro`.)

A `HeartbeatMonitor` tracks per-host liveness against an injectable clock
(tests drive simulated time); missed deadlines become `FailureEvent`s that
the supervisor turns into a recovery action:

  * restart-in-place (transient host loss, capacity unchanged), or
  * **elastic rescale** (`runtime.elastic`) — rebuild the mesh from the
    survivors, re-shard the last checkpoint, and resume; the new placement
    comes from the same LP scheduler that placed the job (the paper's
    reconfiguration applied to a failure-induced capacity change).

Everything is deterministic and unit-tested; on real fleets the heartbeat
source is the cluster manager.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

ACTION_RESTART = "restart"
ACTION_RESCALE = "rescale"


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    host: str
    detected_at: float
    consecutive_misses: int


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    misses: int = 0
    alive: bool = True


class HeartbeatMonitor:
    """Deadline-based failure detector (φ-accrual simplified to a miss
    counter; deadline = interval × tolerance)."""

    def __init__(self, hosts: List[str], interval_s: float = 10.0,
                 miss_threshold: int = 3, clock: Callable[[], float] = time.monotonic):
        self.interval_s = interval_s
        self.miss_threshold = miss_threshold
        self.clock = clock
        now = clock()
        self.hosts: Dict[str, HostState] = {h: HostState(now) for h in hosts}

    def heartbeat(self, host: str) -> None:
        st = self.hosts[host]
        st.last_heartbeat = self.clock()
        st.misses = 0
        if not st.alive:
            st.alive = True  # host rejoined

    def poll(self) -> List[FailureEvent]:
        """Advance detection; returns newly-failed hosts."""
        now = self.clock()
        events: List[FailureEvent] = []
        for host, st in self.hosts.items():
            if not st.alive:
                continue
            misses = int((now - st.last_heartbeat) // self.interval_s)
            st.misses = misses
            if misses >= self.miss_threshold:
                st.alive = False
                events.append(FailureEvent(host, now, misses))
        return events

    def alive_hosts(self) -> List[str]:
        return [h for h, st in self.hosts.items() if st.alive]


@dataclasses.dataclass
class RecoveryPolicy:
    """Maps failures to actions: transient single-host losses restart in
    place up to ``max_restarts``; larger or repeated losses rescale."""

    max_restarts: int = 2
    min_hosts_fraction: float = 0.5
    _restarts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def decide(self, event: FailureEvent, n_alive: int, n_total: int) -> str:
        if n_alive < n_total * self.min_hosts_fraction:
            raise RuntimeError(
                f"unrecoverable: {n_alive}/{n_total} hosts below quorum")
        count = self._restarts.get(event.host, 0)
        if count < self.max_restarts:
            self._restarts[event.host] = count + 1
            return ACTION_RESTART
        return ACTION_RESCALE


class StepTimer:
    """Wall-time guard for a training step — a hung collective (dead peer)
    surfaces as a step exceeding ``timeout_s``, treated like a failed
    heartbeat by the supervisor."""

    def __init__(self, timeout_s: float, clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = self.clock()

    def expired(self) -> bool:
        return self._start is not None and (self.clock() - self._start) > self.timeout_s
