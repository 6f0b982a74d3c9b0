"""Event model of the continuous-operation fleet runtime.

The paper evaluates one reconfiguration over a frozen population (§4); a
real fleet never freezes: apps arrive and leave, demand drifts, nodes fail
and recover — and, since this refactor, *migrations take time*: accepted
moves emit `MigrationStart` / `MigrationComplete` events back into the
queue, and per-app request streams (`RateCurve`) are sampled by periodic
`RequestRateUpdate` events instead of step `DemandDrift` rescaling.

Determinism contract: event order is a total order on ``(time, seq)`` where
``seq`` is the insertion counter — two runs that push the same events in the
same order process them identically, which is what the replay tests assert.
Events the runtime self-schedules (departures, migration completions, rate
samples) inherit determinism from the deterministic dispatch order.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.apps import PlacementRequest


@dataclasses.dataclass(frozen=True)
class RateCurve:
    """Per-app request-rate curve: diurnal sinusoid × burst segments.

    ``rate(t)`` is a dimensionless load multiplier applied to the app's
    admission-time bandwidth/data footprint; it also serves as the app's
    traffic weight in the reconfiguration objective."""

    base: float = 1.0
    amplitude: float = 0.0      # diurnal swing as a fraction of base (0..1)
    period_s: float = 4_000.0
    phase: float = 0.0          # radians
    bursts: Tuple[Tuple[float, float, float], ...] = ()  # (t0_s, dur_s, mult)

    def rate(self, t_s: float) -> float:
        r = self.base
        if self.amplitude:
            r *= 1.0 + self.amplitude * math.sin(
                2.0 * math.pi * t_s / self.period_s + self.phase)
        for t0, dur, mult in self.bursts:
            if t0 <= t_s < t0 + dur:
                r *= mult
        return max(r, 1e-3)


class RateBank:
    """Struct-of-arrays sampler over every alive streamed app's `RateCurve`.

    The runtime's periodic rate resample used to call ``curve.rate(t)`` in
    a Python loop over the whole fleet; at 100k apps that loop dominates a
    quiet tick.  The bank keeps the curve parameters (base, amplitude,
    period, phase) plus each app's currently *admitted* rate in parallel
    numpy arrays — swap-remove on departure, doubling growth on arrival —
    so one ``sample(t, eps)`` call evaluates the sinusoid for the entire
    fleet as a fused vector pass and returns only the apps whose target
    rate moved by more than ``eps`` relative, exactly the set the old loop
    would have re-admitted.  Curves with burst segments fall back to the
    scalar ``rate(t)`` (bursts are rare and piecewise — not worth a mask
    per segment); the vector path applies the identical operation order as
    the scalar path, so amplitude-0 curves reproduce ``base`` bit-exactly.
    """

    def __init__(self) -> None:
        cap = 16
        self._ids: List[int] = []
        self._index: Dict[int, int] = {}
        self._base = np.empty(cap)
        self._amp = np.empty(cap)
        self._period = np.empty(cap)
        self._phase = np.empty(cap)
        self._rate = np.empty(cap)
        self._n = 0
        self._bursty: Dict[int, RateCurve] = {}

    def __len__(self) -> int:
        return self._n

    def __contains__(self, req_id: int) -> bool:
        return req_id in self._index

    def _grow(self) -> None:
        cap = max(16, 2 * len(self._base))
        for name in ("_base", "_amp", "_period", "_phase", "_rate"):
            old = getattr(self, name)
            new = np.empty(cap)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    def add(self, req_id: int, curve: RateCurve, rate: float) -> None:
        """Track ``req_id``'s curve, currently admitted at ``rate``."""
        if req_id in self._index:
            self.discard(req_id)
        if self._n == len(self._base):
            self._grow()
        i = self._n
        self._ids.append(req_id)
        self._index[req_id] = i
        self._base[i] = curve.base
        self._amp[i] = curve.amplitude
        self._period[i] = curve.period_s
        self._phase[i] = curve.phase
        self._rate[i] = rate
        self._n += 1
        if curve.bursts:
            self._bursty[req_id] = curve

    def discard(self, req_id: int) -> None:
        i = self._index.pop(req_id, None)
        if i is None:
            return
        self._bursty.pop(req_id, None)
        last = self._n - 1
        if i != last:
            moved = self._ids[last]
            self._ids[i] = moved
            self._index[moved] = i
            for arr in (self._base, self._amp, self._period,
                        self._phase, self._rate):
                arr[i] = arr[last]
        self._ids.pop()
        self._n = last

    def set_rate(self, req_id: int, rate: float) -> None:
        """Record the rate the app was just re-admitted at."""
        i = self._index.get(req_id)
        if i is not None:
            self._rate[i] = rate

    def sample(self, t_s: float, epsilon: float) -> Dict[int, float]:
        """Evaluate every curve at ``t_s``; return ``{req_id: target}`` for
        the apps whose target moved > ``epsilon`` relative to their
        admitted rate.  Does NOT update the admitted rates — the caller
        confirms each re-admission with `set_rate`."""
        n = self._n
        if n == 0:
            return {}
        target = self._base[:n] * (1.0 + self._amp[:n] * np.sin(
            2.0 * np.pi * t_s / self._period[:n] + self._phase[:n]))
        np.maximum(target, 1e-3, out=target)
        for req_id, curve in self._bursty.items():
            target[self._index[req_id]] = curve.rate(t_s)
        changed = np.abs(target - self._rate[:n]) \
            > epsilon * self._rate[:n]
        return {self._ids[i]: float(target[i])
                for i in np.nonzero(changed)[0]}


@dataclasses.dataclass(frozen=True)
class Event:
    """Base class; concrete events below."""


@dataclasses.dataclass(frozen=True)
class AppArrival(Event):
    """A user submits ``request``; if admitted and ``lifetime_s`` is set, a
    matching `AppDeparture` is self-scheduled by the runtime.  An optional
    ``rate_curve`` turns the app into a request *stream*: its footprint is
    admitted at ``curve.rate(t_arrival)`` and resampled by every
    `RequestRateUpdate`."""

    request: PlacementRequest
    lifetime_s: Optional[float] = None
    rate_curve: Optional[RateCurve] = None


@dataclasses.dataclass(frozen=True)
class AppDeparture(Event):
    req_id: int


@dataclasses.dataclass(frozen=True)
class DemandDrift(Event):
    """Legacy step rescaling: one running app's bandwidth/data footprint is
    multiplied by ``scale`` and the app is re-admitted under its original
    bounds.  ``selector`` picks the victim deterministically (index into the
    alive list modulo its length).  Superseded by `RateCurve` +
    `RequestRateUpdate` for continuous request streams; kept for targeted
    shock tests."""

    selector: int
    scale: float


@dataclasses.dataclass(frozen=True)
class NodeFailure(Event):
    node_id: str


@dataclasses.dataclass(frozen=True)
class NodeRecovery(Event):
    node_id: str


@dataclasses.dataclass(frozen=True)
class LinkFailure(Event):
    """A network link is cut (backbone fibre cut / uplink outage).  Every
    candidate path crossing it becomes infeasible, in-flight transfers over
    it are aborted with source rollback, and apps whose live path uses it
    are evicted and re-placed (or lost)."""

    link_id: str


@dataclasses.dataclass(frozen=True)
class LinkRecovery(Event):
    link_id: str


@dataclasses.dataclass(frozen=True)
class SessionArrival(Event):
    """A user session opens against a *serving* app (`fleet.serving`):
    ``prompt_tokens`` are submitted as one prefill burst at the event time,
    then ``decode_tokens`` per-token decode requests follow at the session's
    cadence (the serving profile's ``decode_tps``, scaled by the app's
    current `RateBank` rate).  Sessions addressed to an app that was never
    admitted — or has already departed — are counted as rejected."""

    req_id: int                 # the serving app this session hits
    session_id: int
    prompt_tokens: int
    decode_tokens: int


@dataclasses.dataclass(frozen=True)
class ReconfigTick(Event):
    """Forced reconfiguration (scenarios use it for time-driven ticks; the
    runtime also self-triggers every ``reconfig_every`` admissions)."""


@dataclasses.dataclass(frozen=True)
class MigrationStart(Event):
    """Marker emitted by the executor when a migration's pipeline actually
    begins (may be later than the tick that planned it, if the move had to
    wait for capacity).  Start means the elastic backend has taken its
    snapshot and the transfer begins occupying link bandwidth
    (`fleet.elastic_bridge`)."""

    req_id: int
    mode: str        # "precopy" | "stop_and_copy"


@dataclasses.dataclass(frozen=True)
class MigrationComplete(Event):
    """Self-scheduled by the executor at the pipeline's projected finish —
    remaining snapshot phase + checkpoint copy at the fair-share link rate
    + restore phase.  ``gen`` guards against staleness: whenever link
    contention changes, the executor re-projects every active transfer
    under a fresh generation and completions carrying an old ``gen`` are
    ignored."""

    req_id: int
    gen: int


@dataclasses.dataclass(frozen=True)
class RequestRateUpdate(Event):
    """Periodic request-stream sampler: re-evaluates every alive app's
    `RateCurve` at the current time and rescales its footprint.  Self-
    reschedules every ``every_s`` until ``horizon_s``."""

    every_s: float
    horizon_s: float


class EventQueue:
    """Min-heap of ``(time, seq, event)`` with deterministic tie-breaking."""

    def __init__(self, events: Iterable[Tuple[float, Event]] = ()) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        for t, ev in events:
            self.push(t, ev)

    def push(self, time_s: float, event: Event) -> None:
        heapq.heappush(self._heap, (float(time_s), self._seq, event))
        self._seq += 1

    def pop(self) -> Tuple[float, Event]:
        t, _, ev = heapq.heappop(self._heap)
        return t, ev

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self) -> Iterator[Tuple[float, Event]]:
        """Drain in order (consumes the queue)."""
        while self._heap:
            yield self.pop()
