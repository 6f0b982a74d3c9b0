"""Token-level serving workload riding on the fleet event loop.

Each serving app runs one deterministic single-server FIFO token queue
in *simulated* time: session arrivals (`events.SessionArrival`)
materialize their prompt tokens as a prefill burst at the arrival time
and their decode tokens at the session cadence; the server drains the
merged queue at ``service_tps``.  The queue is integer-exact and
vectorized — advancing to ``t`` solves the M/D/1-style recurrence

    c[i] = spt·(i+1) + max(free_t, cummax_j≤i (s[j] − j·spt))

in one ``np.maximum.accumulate`` pass, where ``s`` are submit times,
``spt = 1/service_tps`` and ``free_t`` the time the server frees up.
``c`` is strictly increasing, so the tokens completed by ``t`` are a
``searchsorted`` prefix — every token is served exactly once by
construction, which is the invariant the conservation suite pins.

Migrations couple in through two rules:

* while an app's transfer is in flight the queue is frozen at the
  transfer's start time (`advance` clamps to ``executor.active``);
* when the executor retires a `MigrationRecord` the queue is advanced
  to ``t_end − downtime_s`` (pre-copy keeps serving through the copy)
  and then paused across ``[t_end − downtime_s, t_end]`` by bumping
  ``free_t`` — tokens submitted during the pause simply wait.

A completed ``replay`` migration additionally charges the app's cached
context as ``tokens_recomputed`` (the destination re-prefills every
live session); ``kv-ship`` recomputes nothing.  Tokens pending when an
app departs (or is lost to a failure) are counted ``cancelled`` — so
``decoded + cancelled == submitted`` holds for every run, which is the
conservation law the property tests randomize against.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.satisfaction import blend_token_slo, token_slo_ratio

from ..obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    DEFAULT_RATIO_BUCKETS,
    MetricsRegistry,
)
from .profile import STRATEGY_REPLAY, ServingConfig, ServingProfile


class _AppQueue:
    """One serving app's token queue state (struct-of-arrays)."""

    __slots__ = ("req_id", "profile", "submit", "sids", "served", "free_t",
                 "advanced_to", "submitted", "cancelled", "recomputed",
                 "sessions", "latencies", "tick_latencies", "departed")

    def __init__(self, req_id: int, profile: ServingProfile,
                 t0: float) -> None:
        self.req_id = req_id
        self.profile = profile
        self.submit = np.empty(0, np.float64)   # sorted token submit times
        self.sids = np.empty(0, np.int64)       # parallel session ids
        self.served = 0                         # served tokens = sorted prefix
        self.free_t = t0                        # when the server frees up
        self.advanced_to = t0
        self.submitted = 0
        self.cancelled = 0
        self.recomputed = 0
        self.sessions = 0
        self.latencies: List[np.ndarray] = []       # all served latencies
        self.tick_latencies: List[np.ndarray] = []  # since last tick flush
        self.departed = False


class ServingWorkload:
    """Every serving app's token queue plus the fleet-level accounting.

    Created by `FleetRuntime` when ``RuntimeConfig.serving`` is set;
    `attach` binds the runtime's shared `MetricsRegistry` (histograms
    land under the fingerprinted ``serving/`` namespace — absent from
    non-serving runs entirely) and the `MigrationExecutor` whose
    ``active`` table gates queue advances for mid-transfer apps."""

    def __init__(self, config: ServingConfig,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.config = config
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._executor = None
        self._apps: Dict[int, _AppQueue] = {}
        self.sessions = 0
        self.sessions_rejected = 0
        self.strategy_migrations: Dict[str, int] = {}
        # Cached context per app as sized at its last snapshot — what a
        # completed `replay` migration must re-prefill (the same number
        # its restore phase was priced with).
        self._snap_cached: Dict[int, int] = {}

    def attach(self, metrics: MetricsRegistry, executor) -> None:
        self.metrics = metrics
        self._executor = executor

    # ------------------------------------------------------------- accessors
    def __contains__(self, req_id: int) -> bool:
        return req_id in self._apps

    def profile(self, req_id: int) -> Optional[ServingProfile]:
        app = self._apps.get(req_id)
        return app.profile if app is not None else None

    def cached_tokens(self, req_id: int) -> int:
        """Live KV context: served tokens (prompt + decoded so far) of
        sessions that still have pending tokens — what ``kv-ship`` must
        carry and ``replay`` must recompute."""
        app = self._apps.get(req_id)
        if app is None or app.served == 0:
            return 0
        total = np.bincount(app.sids)
        done = np.bincount(app.sids[:app.served], minlength=len(total))
        return int(done[total > done].sum())

    def drain_estimate_s(self, req_id: int,
                         now: Optional[float] = None) -> float:
        """How long a ``drain`` migration would wait before moving cold:
        serve the unserved backlog, including decode tokens whose cadence
        has not submitted them yet (remaining cadence span)."""
        app = self._apps.get(req_id)
        if app is None:
            return 0.0
        pending = len(app.submit) - app.served
        if pending == 0:
            return 0.0
        t = app.advanced_to if now is None else now
        span = max(float(app.submit[-1]) - t, 0.0)
        return span + pending / app.profile.service_tps

    def advance_app(self, req_id: int, now: float) -> None:
        """Bring one app's queue current (frozen apps clamp to their
        transfer start) — the backend calls this before sizing a
        snapshot so ``cached_tokens`` reflects *now*, not the last
        event that happened to touch the queue."""
        app = self._apps.get(req_id)
        if app is not None:
            self._advance(app, self._clamped(req_id, now))

    def note_snapshot(self, req_id: int, cached: int) -> None:
        """The backend took a serving snapshot sized against ``cached``
        context tokens; the matching `MigrationRecord` settles it."""
        self._snap_cached[req_id] = cached

    # --------------------------------------------------------------- events
    def register(self, req_id: int, now: float) -> None:
        """An app with a serving profile was admitted — start its queue."""
        prof = self.config.profiles.get(req_id)
        if prof is not None and req_id not in self._apps:
            self._apps[req_id] = _AppQueue(req_id, prof, now)

    def on_session(self, req_id: int, session_id: int, prompt_tokens: int,
                   decode_tokens: int, now: float, rate: float) -> bool:
        """One session opens: prefill burst at ``now``, then decode tokens
        at the session cadence (``decode_tps`` scaled by the app's live
        admitted rate).  Returns False — counted rejected — when the app
        was never admitted or has departed."""
        app = self._apps.get(req_id)
        if app is None or app.departed:
            self.sessions_rejected += 1
            return False
        self._advance(app, self._clamped(req_id, now))
        cadence = 1.0 / (app.profile.decode_tps * max(rate, 1e-3))
        s_new = np.concatenate([
            np.full(prompt_tokens, now, np.float64),
            now + cadence * np.arange(1, decode_tokens + 1, dtype=np.float64),
        ])
        sid_new = np.full(len(s_new), session_id, np.int64)
        # Merge into the unserved tail only — the served prefix must stay
        # a prefix.  Stable sort keeps already-queued tokens ahead of the
        # new burst on submit-time ties (FIFO fairness, deterministic).
        tail = np.concatenate([app.submit[app.served:], s_new])
        tid = np.concatenate([app.sids[app.served:], sid_new])
        order = np.argsort(tail, kind="stable")
        app.submit = np.concatenate([app.submit[:app.served], tail[order]])
        app.sids = np.concatenate([app.sids[:app.served], tid[order]])
        app.submitted += len(s_new)
        app.sessions += 1
        self.sessions += 1
        return True

    def on_record(self, rec) -> None:
        """The executor retired a migration of this app: credit serving up
        to the pause window's start, then pause across it.  The uniform
        window ``[t_end − downtime_s, t_end]`` covers every outcome —
        completed pre-copy (downtime ≈ dirty-page + restore), completed
        stop-and-copy (≈ the whole pipeline), and aborts (downtime 0 for
        pre-copy: the source never stopped serving)."""
        app = self._apps.get(rec.req_id)
        if app is None:
            return
        self._advance(app, max(app.advanced_to, rec.t_end - rec.downtime_s))
        app.free_t = max(app.free_t, rec.t_end)
        noted = self._snap_cached.pop(rec.req_id, 0)
        if rec.outcome == "completed" and rec.strategy is not None:
            self.strategy_migrations[rec.strategy] = \
                self.strategy_migrations.get(rec.strategy, 0) + 1
            if rec.strategy == STRATEGY_REPLAY:
                # The destination re-prefills the context the snapshot was
                # sized against — the recompute its restore phase priced.
                app.recomputed += noted

    def on_departure(self, req_id: int, now: float) -> None:
        """The app left (scheduled departure or lost to a failure): serve
        what completed by ``now``, cancel the rest."""
        app = self._apps.get(req_id)
        if app is None or app.departed:
            return
        self._advance(app, self._clamped(req_id, now))
        app.cancelled += len(app.submit) - app.served
        app.submit = app.submit[:app.served]
        app.sids = app.sids[:app.served]
        app.departed = True

    def observe_tick(self, now: float) -> None:
        """Advance every queue to the tick time (frozen apps clamp to
        their transfer start) and flush per-app token-latency segments
        into the ``serving/`` histograms + per-tick SLO ratios."""
        m = self.metrics
        for app in self._apps.values():
            self._advance(app, self._clamped(app.req_id, now))
            if not app.tick_latencies:
                continue
            seg = np.concatenate(app.tick_latencies)
            app.tick_latencies.clear()
            m.histogram("serving/token_latency_s",
                        DEFAULT_LATENCY_BUCKETS_S).observe_many(seg)
            m.histogram("serving/token_slo_ratio",
                        DEFAULT_RATIO_BUCKETS).observe(token_slo_ratio(
                            float(np.percentile(seg, 99.0)),
                            app.profile.slo_p99_s))

    # ------------------------------------------------------------- finalize
    def finalize(self, now: float, tel, mean_ratio: float = 2.0) -> None:
        """End of run: serve everything still queued (tokens completing
        after ``now`` count decoded, not decoded-by-end), then write the
        ``serving`` summary onto the telemetry.  Conservation —
        ``decoded + cancelled == submitted`` — holds here by
        construction; the test suite re-derives it per app."""
        decoded_by_end = 0
        for app in self._apps.values():
            # No clamp: a transfer still in flight at end-of-run never
            # retired, so the source kept serving through it.
            self._advance(app, now)
            decoded_by_end += app.served
            self._advance(app, math.inf)
        self.observe_tick(now)   # flush the tail into the histograms
        submitted = sum(a.submitted for a in self._apps.values())
        decoded = sum(a.served for a in self._apps.values())
        cancelled = sum(a.cancelled for a in self._apps.values())
        recomputed = sum(a.recomputed for a in self._apps.values())
        lat = [seg for a in self._apps.values() for seg in a.latencies]
        all_lat = (np.concatenate(lat) if lat
                   else np.empty(0, np.float64))
        p99 = float(np.percentile(all_lat, 99.0)) if all_lat.size else 0.0
        slo_s = min((a.profile.slo_p99_s for a in self._apps.values()),
                    default=0.25)
        ratio = token_slo_ratio(p99, slo_s)
        tel.serving = {
            "apps": len(self._apps),
            "sessions": self.sessions,
            "sessions_rejected": self.sessions_rejected,
            "tokens_submitted": submitted,
            "tokens_decoded": decoded,
            "tokens_cancelled": cancelled,
            "tokens_recomputed": recomputed,
            "tokens_decoded_by_end": decoded_by_end,
            "tokens_per_s": round(decoded_by_end / max(now, 1e-9), 9),
            "p99_token_latency_s": round(p99, 9),
            "slo_ratio": round(ratio, 9),
            "blended_ratio": round(
                blend_token_slo(mean_ratio, ratio,
                                self.config.slo_weight), 9),
            "migrations": {k: self.strategy_migrations[k]
                           for k in sorted(self.strategy_migrations)},
        }

    def conservation(self) -> Dict[int, Dict[str, int]]:
        """Per-app token ledger for the property tests."""
        return {r: {"submitted": a.submitted, "decoded": a.served,
                    "cancelled": a.cancelled, "recomputed": a.recomputed}
                for r, a in self._apps.items()}

    # ------------------------------------------------------------- internal
    def _clamped(self, req_id: int, t: float) -> float:
        """Queue time floor: an app mid-transfer is frozen at the
        transfer's start until the record retires (which then credits
        the copy window per outcome)."""
        if self._executor is not None:
            tr = self._executor.active.get(req_id)
            if tr is not None:
                return min(t, tr.started_s)
        return t

    def _advance(self, app: _AppQueue, to_t: float) -> None:
        if to_t <= app.advanced_to:
            return
        s = app.submit
        j = int(np.searchsorted(s, to_t, side="right"))
        if j > app.served:
            seg = s[app.served:j]
            m = len(seg)
            spt = 1.0 / app.profile.service_tps
            idx = np.arange(m, dtype=np.float64)
            start = np.maximum(np.maximum.accumulate(seg - spt * idx),
                               app.free_t)
            c = start + spt * (idx + 1.0)
            k = int(np.searchsorted(c, to_t, side="right"))
            if k:
                lat = c[:k] - seg[:k]
                app.latencies.append(lat)
                app.tick_latencies.append(lat)
                app.free_t = float(c[k - 1])
                app.served += k
        app.advanced_to = to_t
