"""Fleet supervision policy: observations in, typed actions out.

A copy of ``aggregathor_tpu/supervisor/policy.py`` (pure: it imports no
JAX and touches no process, socket, file or clock).

PURE in the watchdog's sense (``guardian/watchdog.py``): the policy never
touches processes, sockets, files or the wall clock.  Every tick the
actuator passes ``now`` (seconds, any monotonic origin), one
:class:`InstanceObs` per fleet instance, the journal records that arrived
since the last tick and any newly-seen sentinel verdicts; the policy
returns a list of typed actions for the actuator to execute — which the
actuator MUST do immediately (the policy's backoff bookkeeping assumes an
emitted action executed at ``now``).

The action ladder:

- **Restart** — a dead (non-zero exit) or hung (alive but scrape-down)
  instance is restarted under the watchdog's exponential-backoff
  discipline: restart ``k`` opens a grace window of
  ``patience * backoff^k`` seconds during which further downs only
  **Observe** (``backoff_wait``).
- **Quarantine** — flap damping: an instance that needed
  ``max_restarts`` restarts without ever staying healthy for
  ``flap_window`` seconds is crash-looping; restarting it forever would
  thrash the fleet, so it is quarantined (killed and left down) and the
  attempt counter stops.  Staying healthy for a full ``flap_window``
  resets the counter — a one-off kill does not count against the budget
  forever.
- **Retune** — a sustained regime shift in the journal (``retune_streak``
  consecutive ``deadline_window`` at-ceiling events, or as many
  ``bounded_round`` events with timeouts) climbs the instance's declared
  retune ladder: one rung per trigger, ``retune_cooldown`` seconds of
  hysteresis between rungs (inside the cooldown the symptom is only
  **Observe**-d).  Rungs are opaque ``KEY=VALUE`` / ``KEY*X`` argv
  rewrites applied by the actuator — the Overrides rebuild discipline
  one level up: never mutate a running instance, rebuild its config and
  restart it.
- **Rollback** — a sentinel REGRESS verdict (obs/slo.py) rolls the
  instance's checkpoint timeline back through the custody path.  Once
  per verdict identity: the same REGRESS re-observed must not unwind
  the timeline again (``rollback_once``).
- **Observe** — the explicit no-op arm, emitted on REASON CHANGES only
  (not every tick), so the journal tells why nothing happened without
  drowning in heartbeats.

Everything is deterministic given the input stream — tests drive years of
fleet life in microseconds on a synthetic clock.
"""

import collections

from ..utils import UserException, parse_keyval

#: one instance's health as the actuator sees it this tick.  ``alive`` is
#: process-level (a pid that waits), ``exit_code`` is None while running;
#: ``up``/``consecutive_misses``/``last_scrape_age`` mirror the fleet
#: collector's down-judgment inputs (obs/fleet.py ``/fleet/status``) —
#: None age means never scraped.  Instances without a scrape URL pass
#: ``up=None`` (process liveness is then the only signal).
InstanceObs = collections.namedtuple(
    "InstanceObs",
    ("name", "role", "alive", "exit_code", "up", "consecutive_misses",
     "last_scrape_age"),
)

#: typed actions (the actuator maps each to one journal event type)
Restart = collections.namedtuple(
    "Restart", ("instance", "reason", "attempt", "backoff_s", "evidence"))
Quarantine = collections.namedtuple(
    "Quarantine", ("instance", "reason", "attempts", "evidence"))
Retune = collections.namedtuple(
    "Retune", ("instance", "rung", "rung_index", "reason", "evidence"))
Rollback = collections.namedtuple(
    "Rollback", ("instance", "verdict_id", "reason", "evidence"))
Observe = collections.namedtuple(
    "Observe", ("instance", "reason", "evidence"))


class SupervisorConfig:
    """Parsed ``--supervisor-args`` (key:value strings, like every registry).

    Keys: ``patience`` (base restart-backoff seconds, default 2),
    ``backoff`` (growth base, default 2), ``max-restarts`` (restarts
    within one flap window before quarantine, default 5), ``flap-window``
    (healthy seconds that reset the restart budget, default 30),
    ``retune-streak`` (consecutive at-ceiling / timeout events that
    trigger a retune rung, default 3), ``retune-cooldown`` (hysteresis
    seconds between rungs, default 30)."""

    DEFAULTS = {
        "patience": 2.0,
        "backoff": 2.0,
        "max-restarts": 5,
        "flap-window": 30.0,
        "retune-streak": 3,
        "retune-cooldown": 30.0,
    }

    def __init__(self, args=None):
        kv = parse_keyval(args or [], dict(self.DEFAULTS), strict=True)
        self.patience = float(kv["patience"])
        self.backoff = float(kv["backoff"])
        self.max_restarts = int(kv["max-restarts"])
        self.flap_window = float(kv["flap-window"])
        self.retune_streak = int(kv["retune-streak"])
        self.retune_cooldown = float(kv["retune-cooldown"])
        if self.patience <= 0:
            raise UserException(
                "supervisor patience must be > 0 (got %g)" % self.patience)
        if self.backoff < 1.0:
            raise UserException(
                "supervisor backoff must be >= 1 (got %g) — a shrinking "
                "grace window restarts faster the more it flaps" % self.backoff)
        if self.max_restarts < 1:
            raise UserException(
                "supervisor max-restarts must be >= 1 (got %d)" % self.max_restarts)
        if self.retune_streak < 1:
            raise UserException(
                "supervisor retune-streak must be >= 1 (got %d)" % self.retune_streak)

    def describe(self):
        return ("patience=%gs backoff=%g max-restarts=%d flap-window=%gs "
                "retune-streak=%d retune-cooldown=%gs"
                % (self.patience, self.backoff, self.max_restarts,
                   self.flap_window, self.retune_streak, self.retune_cooldown))


class _InstanceState:
    """Per-instance supervision bookkeeping (policy-internal)."""

    __slots__ = ("attempts", "not_before", "quarantined", "healthy_since",
                 "ceiling_streak", "timeout_streak", "retunes_applied",
                 "last_retune_at", "rollbacks_done", "last_observe_reason",
                 "streak_refs")

    def __init__(self):
        self.attempts = 0           # restarts issued this flap episode
        self.not_before = None      # no restart before this time (backoff)
        self.quarantined = False
        self.healthy_since = None   # when the instance last became healthy
        self.ceiling_streak = 0     # consecutive at-ceiling deadline moves
        self.timeout_streak = 0     # consecutive rounds with timeouts
        self.retunes_applied = 0    # rungs climbed
        self.last_retune_at = None
        self.rollbacks_done = set() # verdict identities already rolled back
        #: last Observe reason per domain ("liveness"/"retune"/"rollback") —
        #: Observe fires on reason CHANGES within its domain, so a liveness
        #: recovery does not re-arm a still-true retune observation
        self.last_observe_reason = {}
        self.streak_refs = []       # (type, seq) of streak-forming events


class SupervisorPolicy:
    """The pure fleet-supervision decision layer.  ``retunes`` maps an
    instance name to its rung ladder (a sequence of opaque rung strings
    the actuator knows how to apply); instances without a ladder never
    receive Retune actions, however loud their journals get."""

    def __init__(self, config=None, retunes=None):
        self.config = config if config is not None else SupervisorConfig()
        self.retunes = {
            str(name): tuple(rungs) for name, rungs in (retunes or {}).items()
        }
        self._states = {}

    def state_of(self, name):
        return self._states.setdefault(name, _InstanceState())

    def is_quarantined(self, name):
        return self.state_of(name).quarantined

    # ------------------------------------------------------------------ #
    # the tick

    def tick(self, now, observations, journal_events=(), verdicts=()):
        """One decision round.

        ``observations``: iterable of :class:`InstanceObs`.
        ``journal_events``: iterable of ``(instance_name, record)`` — the
        records appended to each instance's journal since the last tick
        (the actuator's ``tail_journal`` cursors guarantee exactly-once).
        ``verdicts``: iterable of ``(instance_name, verdict_doc)`` —
        sentinel verdict documents (obs/slo.py) not seen before.

        Returns the actions to execute, in order; the actuator must
        execute all of them at (effectively) ``now``.
        """
        now = float(now)
        observations = list(observations)
        actions = []
        self._ingest_events(journal_events)
        for obs in observations:
            actions.extend(self._decide_liveness(now, obs))
        actions.extend(self._decide_retunes(now, observations))
        actions.extend(self._decide_rollbacks(now, verdicts))
        return actions

    # ------------------------------------------------------------------ #
    # journal ingestion (the regime-shift detectors)

    def _ingest_events(self, journal_events):
        for name, record in journal_events:
            state = self.state_of(name)
            etype = record.get("type")
            if etype == "deadline_window":
                if record.get("at_ceiling"):
                    state.ceiling_streak += 1
                    state.streak_refs.append((etype, record.get("seq")))
                else:
                    state.ceiling_streak = 0
                    if not state.timeout_streak:
                        state.streak_refs = []
            elif etype == "bounded_round":
                if record.get("timed_out"):
                    state.timeout_streak += 1
                    state.streak_refs.append((etype, record.get("seq")))
                else:
                    state.timeout_streak = 0
                    if not state.ceiling_streak:
                        state.streak_refs = []

    # ------------------------------------------------------------------ #
    # liveness: restart / quarantine / observe

    def _down_reason(self, obs):
        """None when healthy/finished, else 'dead' or 'hung'."""
        if not obs.alive:
            if obs.exit_code == 0:
                return None          # ran to completion: not a fault
            return "dead"
        if obs.up is False:
            return "hung"            # process waits, scrapes judge it down
        return None

    def _observe(self, state, name, domain, reason, evidence):
        """Emit Observe only when the reason CHANGES within its domain."""
        if state.last_observe_reason.get(domain) == reason:
            return []
        state.last_observe_reason[domain] = reason
        return [Observe(instance=name, reason=reason, evidence=evidence)]

    def _decide_liveness(self, now, obs):
        config = self.config
        state = self.state_of(obs.name)
        reason = self._down_reason(obs)
        evidence = {
            "alive": bool(obs.alive),
            "exit_code": obs.exit_code,
            "up": obs.up,
            "consecutive_misses": obs.consecutive_misses,
            "last_scrape_age_seconds": obs.last_scrape_age,
        }
        if reason is None:
            if not obs.alive:       # exit 0: finished, never restarted
                return self._observe(state, obs.name, "liveness", "finished", evidence)
            healthy = obs.up is not False
            if healthy:
                if state.healthy_since is None:
                    state.healthy_since = now
                # flap damping, the forgiving half: a full healthy window
                # refunds the restart budget
                if (state.attempts
                        and now - state.healthy_since >= config.flap_window):
                    state.attempts = 0
                    state.not_before = None
                state.last_observe_reason.pop("liveness", None)
            return []
        state.healthy_since = None
        if state.quarantined:
            return self._observe(state, obs.name, "liveness", "quarantined", evidence)
        if state.attempts >= config.max_restarts:
            # flap damping, the protective half: the budget is spent
            # without a single full healthy window — crash loop
            state.quarantined = True
            state.last_observe_reason.pop("liveness", None)
            return [Quarantine(
                instance=obs.name, reason="crash_loop",
                attempts=state.attempts, evidence=evidence,
            )]
        if state.not_before is not None and now < state.not_before:
            evidence = dict(evidence, not_before=state.not_before)
            return self._observe(state, obs.name, "liveness", "backoff_wait", evidence)
        attempt = state.attempts
        grace = config.patience * config.backoff ** attempt
        state.attempts = attempt + 1
        state.not_before = now + grace
        state.last_observe_reason.pop("liveness", None)
        return [Restart(
            instance=obs.name, reason=reason, attempt=attempt,
            backoff_s=grace, evidence=evidence,
        )]

    # ------------------------------------------------------------------ #
    # retune: sustained regime shifts climb the declared ladder

    def _decide_retunes(self, now, observations):
        config = self.config
        actions = []
        for obs in observations:
            ladder = self.retunes.get(obs.name)
            state = self.state_of(obs.name)
            streak = max(state.ceiling_streak, state.timeout_streak)
            if not ladder or streak < config.retune_streak:
                continue
            trigger = ("deadline_ceiling"
                       if state.ceiling_streak >= state.timeout_streak
                       else "timeout_wave")
            evidence = {
                "trigger": trigger,
                "streak": streak,
                "events": [
                    {"type": t, "seq": s}
                    for t, s in state.streak_refs[-streak:]
                ],
            }
            if state.retunes_applied >= len(ladder):
                actions.extend(self._observe(
                    state, obs.name, "retune", "retune_ladder_exhausted",
                    evidence))
                continue
            if (state.last_retune_at is not None
                    and now - state.last_retune_at < config.retune_cooldown):
                evidence = dict(
                    evidence,
                    cooldown_until=state.last_retune_at + config.retune_cooldown,
                )
                actions.extend(self._observe(
                    state, obs.name, "retune", "retune_hysteresis", evidence))
                continue
            rung_index = state.retunes_applied
            state.retunes_applied = rung_index + 1
            state.last_retune_at = now
            state.ceiling_streak = 0
            state.timeout_streak = 0
            state.streak_refs = []
            state.last_observe_reason.pop("retune", None)
            actions.append(Retune(
                instance=obs.name, rung=ladder[rung_index],
                rung_index=rung_index, reason=trigger, evidence=evidence,
            ))
        return actions

    # ------------------------------------------------------------------ #
    # rollback: sentinel REGRESS, once per verdict identity

    @staticmethod
    def _regressed_metrics(verdict):
        """The failing metric names: the sentinel's verdict document lists
        per-metric ``checks`` (status ``"regressed"``); a hand-built
        verdict may carry a bare ``failures`` list instead."""
        checks = verdict.get("checks")
        if checks:
            return [c.get("metric", "?") for c in checks
                    if c.get("status") == "regressed"]
        return [f.get("metric", "?") for f in verdict.get("failures", ())]

    @staticmethod
    def verdict_identity(verdict):
        """The once-only key for a sentinel verdict document: judged_at is
        unique per judgment; a verdict missing it degrades to the (run_id,
        failure set) pair — same regression, same identity."""
        judged = verdict.get("judged_at")
        if judged is not None:
            return "judged_at:%r" % (judged,)
        return "run:%r failures:%r" % (
            verdict.get("run_id"),
            sorted(SupervisorPolicy._regressed_metrics(verdict)),
        )

    def _decide_rollbacks(self, now, verdicts):
        actions = []
        for name, verdict in verdicts:
            if not isinstance(verdict, dict):
                continue
            state = self.state_of(name)
            if verdict.get("verdict") != "REGRESS":
                continue
            identity = self.verdict_identity(verdict)
            evidence = {
                "verdict_id": identity,
                "judged_at": verdict.get("judged_at"),
                "run_id": verdict.get("run_id"),
                "failures": self._regressed_metrics(verdict),
            }
            if identity in state.rollbacks_done:
                actions.extend(self._observe(
                    state, name, "rollback", "rollback_once", evidence))
                continue
            state.rollbacks_done.add(identity)
            state.last_observe_reason.pop("rollback", None)
            actions.append(Rollback(
                instance=name, verdict_id=identity,
                reason="sentinel_regress", evidence=evidence,
            ))
        return actions
