"""Dual-clock span tracer with Chrome/Perfetto ``trace_event`` export.

Fleet time is *simulated* (migrations occupy sim seconds on links) while
solver work is *wall-clock* (a tick takes zero sim time but real CPU
time) — one clock cannot render both.  The tracer therefore keeps two
timelines, exported as two processes in the trace:

* ``pid 1`` — **simulated time**: migration pipelines as nested spans
  (``migrate #k`` wrapping its ``snapshot`` / ``copy`` / ``restore``
  phases, one track per migration), plus every fleet event (arrival,
  failure, rate sample, SLO breach …) as an instant event;
* ``pid 2`` — **wall clock**: tick phases as nested spans (``tick`` →
  ``plan`` → ``journal_scan`` / ``region_solve`` / ``arbitration`` →
  ``commit``) on one planner track, timestamped against the tracer's
  epoch so consecutive ticks lay out left to right.

Nesting needs no explicit parent links: Chrome's ``ph: "X"`` complete
events nest by time containment per ``(pid, tid)`` track, so emitting
spans with honest begin/end suffices.  ``SpanTracer.write(path)``
produces a JSON object-format trace any ``chrome://tracing`` or
https://ui.perfetto.dev load directly.

Behavior-neutrality contract: the tracer only *observes* — it never
mutates engine/executor state, consumes randomness, or gates a branch —
so `Telemetry.fingerprint()` with tracing attached is bit-identical to a
run without (asserted for all nine scale-×1 scenarios by
``tests/test_observability.py``).  Hot paths guard on
``tracer.enabled``, and the default `NULL_TRACER` no-ops everything.
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

PID_SIM = 1         # simulated-time process in the exported trace
PID_WALL = 2        # wall-clock (solver work) process

#: Well-known track names.
TRACK_FLEET = "fleet-events"      # sim instants: arrivals, failures, …
TRACK_PLANNER = "planner"         # wall spans: tick phases


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span on either clock.  ``t0``/``t1`` are seconds on
    the span's clock (sim seconds, or wall seconds since the tracer's
    epoch)."""

    name: str
    cat: str
    clock: str                    # "sim" | "wall"
    track: str
    t0: float
    t1: float
    args: Optional[Dict] = None

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class InstantEvent:
    """A zero-duration marker on the simulated timeline."""

    name: str
    cat: str
    track: str
    t_s: float
    args: Optional[Dict] = None


class _NullSpanCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullSpanCtx()


class NullTracer:
    """No-op tracer; the default everywhere so instrumented code pays
    one attribute check when tracing is off."""

    enabled = False

    def span(self, name: str, cat: str = "tick", track: str = TRACK_PLANNER,
             args: Optional[Dict] = None):
        return _NULL_CTX

    def add_span(self, name: str, cat: str, track: str,
                 t0_s: float, t1_s: float, args: Optional[Dict] = None) -> None:
        pass

    def instant(self, name: str, t_s: float, cat: str = "event",
                track: str = TRACK_FLEET, args: Optional[Dict] = None) -> None:
        pass


NULL_TRACER = NullTracer()


class SpanTracer(NullTracer):
    """Collecting tracer.  ``span()`` measures wall clock around a
    ``with`` block; ``add_span()`` records an explicit simulated-time
    interval; ``instant()`` drops a sim-time marker."""

    enabled = True

    def __init__(self) -> None:
        self._epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.instants: List[InstantEvent] = []

    # ------------------------------------------------------------ record
    @contextmanager
    def span(self, name: str, cat: str = "tick", track: str = TRACK_PLANNER,
             args: Optional[Dict] = None) -> Iterator[None]:
        t0 = time.perf_counter() - self._epoch
        try:
            yield
        finally:
            t1 = time.perf_counter() - self._epoch
            self.spans.append(Span(name, cat, "wall", track, t0, t1, args))

    def add_span(self, name: str, cat: str, track: str,
                 t0_s: float, t1_s: float, args: Optional[Dict] = None) -> None:
        self.spans.append(Span(name, cat, "sim", track,
                               float(t0_s), float(t1_s), args))

    def instant(self, name: str, t_s: float, cat: str = "event",
                track: str = TRACK_FLEET, args: Optional[Dict] = None) -> None:
        self.instants.append(InstantEvent(name, cat, track, float(t_s), args))

    # ------------------------------------------------------------ export
    def _track_ids(self) -> Dict[Tuple[int, str], int]:
        """Stable (pid, track-name) → tid assignment: well-known tracks
        first, then discovery order."""
        tids: Dict[Tuple[int, str], int] = {
            (PID_SIM, TRACK_FLEET): 1,
            (PID_WALL, TRACK_PLANNER): 1,
        }
        nxt = {PID_SIM: 2, PID_WALL: 2}
        for sp in self.spans:
            pid = PID_SIM if sp.clock == "sim" else PID_WALL
            key = (pid, sp.track)
            if key not in tids:
                tids[key] = nxt[pid]
                nxt[pid] += 1
        for ev in self.instants:
            key = (PID_SIM, ev.track)
            if key not in tids:
                tids[key] = nxt[PID_SIM]
                nxt[PID_SIM] += 1
        return tids

    def to_trace_events(self) -> List[Dict]:
        """The ``traceEvents`` list: metadata (process/thread names) +
        one ``ph:"X"`` complete event per span + ``ph:"i"`` instants.
        Timestamps are microseconds as the format requires."""
        tids = self._track_ids()
        events: List[Dict] = []
        for pid, pname in ((PID_SIM, "simulated time"),
                           (PID_WALL, "wall clock (solver)")):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": pname}})
        for (pid, track), tid in sorted(tids.items(),
                                        key=lambda kv: (kv[0][0], kv[1])):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": track}})
        for sp in self.spans:
            pid = PID_SIM if sp.clock == "sim" else PID_WALL
            ev = {
                "ph": "X",
                "name": sp.name,
                "cat": sp.cat,
                "pid": pid,
                "tid": tids[(pid, sp.track)],
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round(max(sp.duration_s, 0.0) * 1e6, 3),
            }
            if sp.args:
                ev["args"] = sp.args
            events.append(ev)
        for iev in self.instants:
            ev = {
                "ph": "i",
                "name": iev.name,
                "cat": iev.cat,
                "pid": PID_SIM,
                "tid": tids[(PID_SIM, iev.track)],
                "ts": round(iev.t_s * 1e6, 3),
                "s": "t",          # thread-scoped instant
            }
            if iev.args:
                ev["args"] = iev.args
            events.append(ev)
        return events

    def to_dict(self) -> Dict:
        return {"traceEvents": self.to_trace_events(),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Write the trace JSON; returns the number of trace events."""
        doc = self.to_dict()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


# ------------------------------------------------------------- validation
_REQUIRED_X = ("ph", "ts", "dur", "pid", "tid", "name")
_REQUIRED_I = ("ph", "ts", "pid", "tid", "name")


def validate_trace(doc: Dict) -> List[str]:
    """Schema + content lint of an exported trace document.  Returns a
    list of problems (empty = valid).  Checks the ``trace_event`` keys
    every viewer needs, span sanity (non-negative durations), and the
    fleet-specific content contract: at least one tick-phase span and at
    least one migration span nesting all three pipeline phases inside
    its interval on the same track."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    ticks = 0
    mig_tracks: Dict[Tuple[int, int], Dict[str, Tuple[float, float]]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        required = _REQUIRED_X if ph == "X" else _REQUIRED_I
        missing = [k for k in required if k not in ev]
        if missing:
            problems.append(f"event {i} ({ev.get('name')!r}): missing {missing}")
            continue
        if ph == "X":
            if ev["dur"] < 0:
                problems.append(f"event {i} ({ev['name']!r}): negative dur")
            if ev["name"] == "tick":
                ticks += 1
            if ev.get("cat") == "migration":
                key = (ev["pid"], ev["tid"])
                mig_tracks.setdefault(key, {})[ev["name"]] = (
                    ev["ts"], ev["ts"] + ev["dur"])
        elif ph not in ("i", "I"):
            problems.append(f"event {i}: unexpected ph {ph!r}")
    if ticks == 0:
        problems.append("no tick span found")
    complete = 0
    for key, spans in mig_tracks.items():
        parent = next(((t0, t1) for name, (t0, t1) in spans.items()
                       if name.startswith("migrate")), None)
        if parent is None:
            continue
        phases = [spans.get(p) for p in ("snapshot", "copy", "restore")]
        if all(p is not None for p in phases):
            eps = 1e-3   # µs rounding slack
            if all(parent[0] - eps <= p[0] and p[1] <= parent[1] + eps
                   for p in phases):
                complete += 1
            else:
                problems.append(f"track {key}: phases escape migrate span")
    if not complete:
        problems.append("no migration span with nested "
                        "snapshot/copy/restore phases")
    return problems
