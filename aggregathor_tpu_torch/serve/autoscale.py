"""Registry-driven serving autoscaler: pressure in, pool decisions out.

A copy of ``aggregathor_tpu/serve/autoscale.py`` (the module imports no
JAX).  The serving pool has two scalable axes, both driven from the SAME
live signals read off the one process-wide metrics registry
(``obs/metrics.py``): queue depth (``serve_queue_rows``), the request p99
(the ``serve_request_latency_seconds`` reservoir) and the shed rate
(``serve_shed_requests_total`` deltas):

- **dispatch lanes** (``ContinuousBatcher.set_lanes``): concurrent
  in-flight batches over the SHARED bucket ladder, the cheap capacity
  lever;
- **vote replicas** (``InferenceEngine.set_active_replicas``): under
  pressure that out-lasts the lane ceiling, redundancy is traded for
  capacity by RETIRING replicas from the vote (most-suspect first).  A
  retired replica is a NaN row to the vote and SPENDS the declared-f
  budget, so the pool floor is a feasibility statement, not a knob: at most
  ``f - fault_reserve`` replicas may ever be retired, and each depth is
  PROBED against the actual rule (``InferenceEngine.vote_absorbs_retired``).
  Calm re-admits replicas BEFORE dropping lanes: redundancy is restored
  first.

Both axes are flattened into one :class:`CapacityLadder` of rungs ordered
by capacity, ``(lanes 1..L, retired 0)`` then ``(L, retired 1..k)``, and a
PURE hysteresis policy (:class:`AutoscalePolicy`: synthetic clock, no
threads) decides when to move: sustained pressure for ``up-patience`` ticks
climbs one rung, sustained calm for ``down-patience`` ticks descends one,
and every move opens a ``cooldown`` window.  :class:`PoolAutoscaler` is the
thin executor around it: sample, decide, apply, and account
(``serve_autoscale_*`` instruments, a tagged ``serve_autoscale`` summary
event and journal event per move).
"""

import threading
import time

from ..obs import events
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..utils import UserException, info, parse_keyval


class AutoscaleConfig:
    """Parsed ``--autoscale-args`` (key:value strings, like every registry).

    Keys: ``interval`` (seconds between ticks, default 1), ``high-queue`` /
    ``low-queue`` (queued rows), ``high-p99`` / ``low-p99`` (seconds),
    ``high-shed`` / ``low-shed`` (sheds/s), ``up-patience`` /
    ``down-patience`` (consecutive pressured/calm ticks before a move —
    scale up fast, down slowly), ``cooldown`` (seconds both directions are
    suppressed after a move), ``fault-reserve`` (declared-f budget slots
    NEVER spent on retirement — kept for real replica faults), ``min-lanes``
    (the lane floor calm may descend to)."""

    DEFAULTS = {
        "interval": 1.0,
        "high-queue": 64.0,
        "low-queue": 4.0,
        "high-p99": 0.5,
        "low-p99": 0.1,
        "high-shed": 0.5,
        "low-shed": 0.0,
        "up-patience": 2,
        "down-patience": 6,
        "cooldown": 3.0,
        "fault-reserve": 1,
        "min-lanes": 1,
    }

    def __init__(self, args=None):
        kv = parse_keyval(args or [], dict(self.DEFAULTS), strict=True)
        self.interval = float(kv["interval"])
        self.high_queue = float(kv["high-queue"])
        self.low_queue = float(kv["low-queue"])
        self.high_p99 = float(kv["high-p99"])
        self.low_p99 = float(kv["low-p99"])
        self.high_shed = float(kv["high-shed"])
        self.low_shed = float(kv["low-shed"])
        self.up_patience = int(kv["up-patience"])
        self.down_patience = int(kv["down-patience"])
        self.cooldown = float(kv["cooldown"])
        self.fault_reserve = int(kv["fault-reserve"])
        self.min_lanes = int(kv["min-lanes"])
        if self.interval <= 0.0:
            raise UserException("autoscale interval must be > 0 seconds")
        for high, low, name in (
            (self.high_queue, self.low_queue, "queue"),
            (self.high_p99, self.low_p99, "p99"),
            (self.high_shed, self.low_shed, "shed"),
        ):
            if low < 0.0 or high < low:
                raise UserException(
                    "autoscale %s watermarks want 0 <= low (%g) <= high (%g)"
                    % (name, low, high)
                )
        if self.up_patience < 1 or self.down_patience < 1:
            raise UserException("autoscale patience values must be >= 1")
        if self.cooldown < 0.0:
            raise UserException("autoscale cooldown must be >= 0 seconds")
        if self.fault_reserve < 0:
            raise UserException("autoscale fault-reserve must be >= 0")
        if self.min_lanes < 1:
            raise UserException("autoscale min-lanes must be >= 1")


class AutoscalePolicy:
    """Pure hysteresis controller: one observation per tick, a direction out.

    ``observe(now, queue_rows, p99_s, shed_rate)`` returns ``"expand"``
    (sustained pressure), ``"shrink"`` (sustained calm) or ``None``.
    Pressure is ANY watermark exceeded (queue > high-queue, p99 > high-p99,
    shed rate > high-shed); calm is EVERY signal at/below its low
    watermark; the band between resets both streaks (no decision ever
    forms inside the hysteresis gap).  An unmeasured p99 (no completed
    requests yet) counts as calm-compatible, never as pressure.  After a
    decision both streaks reset and a ``cooldown`` window suppresses the
    next move — the serving twin of the guardian's spike-cooldown
    (guardian/watchdog.py).  Deterministic in its inputs: no wall clock,
    no registry — the executor owns sampling.
    """

    def __init__(self, config):
        self.config = config
        self.pressure_streak = 0
        self.calm_streak = 0
        self.cooldown_until = -float("inf")
        self.last_reason = None

    def observe(self, now, queue_rows, p99_s, shed_rate):
        cfg = self.config
        pressured = (
            queue_rows > cfg.high_queue
            or (p99_s is not None and p99_s > cfg.high_p99)
            or shed_rate > cfg.high_shed
        )
        calm = (
            queue_rows <= cfg.low_queue
            and (p99_s is None or p99_s <= cfg.low_p99)
            and shed_rate <= cfg.low_shed
        )
        if pressured:
            self.pressure_streak += 1
            self.calm_streak = 0
        elif calm:
            self.calm_streak += 1
            self.pressure_streak = 0
        else:  # inside the hysteresis band: no opinion forms
            self.pressure_streak = 0
            self.calm_streak = 0
        if now < self.cooldown_until:
            return None
        if self.pressure_streak >= cfg.up_patience:
            self.last_reason = (
                "pressure sustained %d tick(s): queue=%g p99=%s shed/s=%g"
                % (self.pressure_streak, queue_rows,
                   "%.4g" % p99_s if p99_s is not None else "-", shed_rate)
            )
            self.pressure_streak = self.calm_streak = 0
            self.cooldown_until = now + cfg.cooldown
            return "expand"
        if self.calm_streak >= cfg.down_patience:
            self.last_reason = (
                "calm sustained %d tick(s): queue=%g p99=%s shed/s=%g"
                % (self.calm_streak, queue_rows,
                   "%.4g" % p99_s if p99_s is not None else "-", shed_rate)
            )
            self.pressure_streak = self.calm_streak = 0
            self.cooldown_until = now + cfg.cooldown
            return "shrink"
        return None


class CapacityLadder:
    """The ordered capacity rungs: lanes first, replica retirement last.

    ``rung(i) -> (lanes, nb_retired)``: indices ``0..L-min_lanes`` grow the
    lane pool from ``min_lanes`` to ``max_lanes`` with full redundancy;
    indices beyond retire ``1..max_retire`` replicas at the lane ceiling.
    ``max_retire`` IS the declared-f feasibility floor in ladder form —
    the constructor caller (:class:`PoolAutoscaler`) derives it from
    ``min(f - fault_reserve, deepest probed-absorbable retirement)``, so no
    rung that exists can ever overdraw the vote's budget.
    """

    def __init__(self, min_lanes, max_lanes, max_retire):
        min_lanes, max_lanes = int(min_lanes), int(max_lanes)
        max_retire = int(max_retire)
        if not 1 <= min_lanes <= max_lanes:
            raise UserException(
                "capacity ladder wants 1 <= min_lanes (%d) <= max_lanes (%d)"
                % (min_lanes, max_lanes)
            )
        if max_retire < 0:
            raise UserException("max_retire must be >= 0")
        self.rungs = tuple(
            [(lanes, 0) for lanes in range(min_lanes, max_lanes + 1)]
            + [(max_lanes, retired) for retired in range(1, max_retire + 1)]
        )

    def __len__(self):
        return len(self.rungs)

    def rung(self, index):
        return self.rungs[index]

    def index_of(self, lanes, nb_retired):
        """The rung matching a live (lanes, retired) state; the closest
        not-larger rung when the state was set out-of-band."""
        best = 0
        for index, (rung_lanes, rung_retired) in enumerate(self.rungs):
            if (rung_retired, rung_lanes) <= (int(nb_retired), int(lanes)):
                best = index
        return best


class PoolAutoscaler:
    """Samples the registry, runs the policy, applies rung moves.

    Args:
      server: the :class:`~.frontend.InferenceServer` composite (scheduler
        + engine + disagreement state).
      config: an :class:`AutoscaleConfig`.
      registry: metrics registry to SAMPLE from and account into (default
        the process-wide one — must be the registry the server exports
        through, or the autoscaler would act on someone else's signals).
      clock: injectable monotonic clock (tests drive ``tick`` with
        synthetic time; ``start`` uses it only for bookkeeping).

    ``tick()`` is one full sample->decide->apply cycle and is safe to call
    manually (tests, or a trainer-style loop); ``start()`` runs it every
    ``config.interval`` seconds on a daemon thread.
    """

    def __init__(self, server, config=None, registry=None, clock=None):
        self.server = server
        self.config = config if config is not None else AutoscaleConfig()
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self.clock = clock if clock is not None else time.monotonic
        self.policy = AutoscalePolicy(self.config)
        engine = server.engine
        scheduler = server.scheduler
        retirable = 0
        if engine.gar is not None and engine.nb_replicas > 1:
            budget = max(0, engine.gar.nb_byz_workers - self.config.fault_reserve)
            while (retirable < budget
                   and engine.vote_absorbs_retired(retirable + 1)):
                retirable += 1
        self.ladder = CapacityLadder(
            min(self.config.min_lanes, scheduler.max_lanes),
            scheduler.max_lanes, retirable,
        )
        self._lock = threading.Lock()
        self._rung = self.ladder.index_of(
            scheduler.nb_lanes, engine.nb_replicas - len(engine.active_replicas)
        )
        self._last_shed = None
        self._last_sample_at = None
        self._last_latency_count = None
        self._thread = None
        self._stop = threading.Event()
        self._metric_names = [
            "serve_autoscale_rung", "serve_autoscale_events_total",
            "serve_autoscale_at_ceiling", "serve_shed_rate",
        ]
        self._g_rung = self.registry.gauge(
            "serve_autoscale_rung", "Current capacity rung (0 = floor)"
        )
        self._g_rung.set(self._rung)
        self._g_ceiling = self.registry.gauge(
            "serve_autoscale_at_ceiling",
            "1 while pressure demands more capacity than the top rung "
            "(lanes maxed, retirement at the declared-f floor)",
        )
        self._c_events = self.registry.counter(
            "serve_autoscale_events_total", "Applied scale moves",
            labelnames=("direction",),
        )
        self._g_shed_rate = self.registry.gauge(
            "serve_shed_rate", "Sheds per second over the last autoscale tick"
        )

    # ------------------------------------------------------------------ #
    # sampling (registry in, one observation out)

    def sample(self, now):
        """(queue_rows, p99_s, shed_rate) read from the live registry.

        The latency reservoir is all-time, not windowed, so a tail spike
        decays only as new requests displace old samples — a STALE p99
        (no request completed since the last tick) is therefore reported
        as None (unmeasured: calm-compatible, never pressure), or an idle
        server would stay pinned at its last loaded reading forever.
        Queue depth and the per-tick shed-rate delta are the live
        pressure signals; the p99 watermark catches sustained slow
        serving under sustained traffic."""
        families = {f.name: f for f in self.registry.families()}
        queue = families.get("serve_queue_rows")
        queue_rows = float(queue.value) if queue is not None else 0.0
        latency = families.get("serve_request_latency_seconds")
        tail = latency.percentiles() if latency is not None else None
        count = int(latency.count) if latency is not None else 0
        shed = families.get("serve_shed_requests_total")
        shed_total = float(shed.value) if shed is not None else 0.0
        with self._lock:
            last_shed, last_at = self._last_shed, self._last_sample_at
            last_count = self._last_latency_count
            self._last_shed, self._last_sample_at = shed_total, now
            self._last_latency_count = count
        fresh = last_count is None or count > last_count
        p99_s = float(tail["p99"]) if (tail and fresh) else None
        if last_shed is None or last_at is None or now <= last_at:
            shed_rate = 0.0
        else:
            shed_rate = max(0.0, shed_total - last_shed) / (now - last_at)
        self._g_shed_rate.set(shed_rate)
        return queue_rows, p99_s, shed_rate

    # ------------------------------------------------------------------ #
    # decide + apply

    @property
    def rung(self):
        with self._lock:
            return self._rung

    def tick(self, now=None):
        """One sample->decide->apply cycle; returns the applied direction
        (``"expand"``/``"shrink"``) or None."""
        now = self.clock() if now is None else now
        queue_rows, p99_s, shed_rate = self.sample(now)
        decision = self.policy.observe(now, queue_rows, p99_s, shed_rate)
        with self._lock:
            rung = self._rung
        at_ceiling = rung >= len(self.ladder) - 1
        wants_more = decision == "expand" or self.policy.pressure_streak > 0
        self._g_ceiling.set(1.0 if (at_ceiling and wants_more) else 0.0)
        if decision is None:
            return None
        target = rung + (1 if decision == "expand" else -1)
        target = max(0, min(len(self.ladder) - 1, target))
        if target == rung:
            return None  # pinned at the floor/ceiling: nothing to apply
        self._apply(target, decision, now)
        return decision

    def _apply(self, target, direction, now):
        lanes, nb_retired = self.ladder.rung(target)
        engine = self.server.engine
        keep = self._retirement_plan(nb_retired)
        engine.set_active_replicas(keep)
        self.server.scheduler.set_lanes(lanes)
        with self._lock:
            self._rung = target
        self._g_rung.set(target)
        self._c_events.labels(direction=direction).inc()
        trace.instant("serve.autoscale", cat="serve", direction=direction,
                      rung=int(target), lanes=int(lanes),
                      retired=int(nb_retired))
        events.emit("serve_autoscale",
                    step=self.server.scheduler.batch_count,
                    direction=direction, rung=int(target), lanes=int(lanes),
                    retired=int(nb_retired), active_replicas=keep,
                    reason=self.policy.last_reason)
        info("autoscale %s -> rung %d (lanes=%d, active replicas=%r): %s"
             % (direction, target, lanes, keep, self.policy.last_reason))
        if self.server.summaries is not None:
            self.server.summaries.event(
                self.server.scheduler.batch_count, "serve_autoscale", {
                    "direction": direction,
                    "rung": int(target),
                    "lanes": int(lanes),
                    "active_replicas": keep,
                    "reason": self.policy.last_reason,
                })

    def _retirement_plan(self, nb_retired):
        """Active indices keeping ``R - nb_retired`` replicas: the highest
        latest-disagreement scorers go first (a suspect replica is the
        first traded for capacity), non-finite scores first of all."""
        engine = self.server.engine
        scores = self.server.last_disagreement()

        def badness(index):
            score = scores[index] if index < len(scores) else 0.0
            if score != score:  # NaN: already retired, keep it retired first
                return (3, 0.0)
            if score in (float("inf"), float("-inf")):
                return (2, 0.0)
            return (1, float(score))

        order = sorted(range(engine.nb_replicas), key=badness, reverse=True)
        retired = set(order[:nb_retired])
        return [i for i in range(engine.nb_replicas) if i not in retired]

    # ------------------------------------------------------------------ #
    # lifecycle

    def start(self):
        """Tick every ``config.interval`` seconds on a daemon thread."""
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="serve-autoscaler"
            )
            thread = self._thread
        thread.start()

    def _run(self):
        while not self._stop.wait(self.config.interval):
            try:
                self.tick()
            except Exception as exc:  # a bad tick must not kill the pool
                info("autoscale tick failed: %s: %s"
                     % (type(exc).__name__, exc))

    def close(self):
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5.0)
        for name in self._metric_names:
            self.registry.unregister(name)
