"""Host-side divergence watchdog: probe stream in, rollback decisions out.

Copy of ``aggregathor_tpu/guardian/watchdog.py``; its instants go to this
package's span tracer (``obs/trace.py``) and its records to its journal
(``obs/events.py``).

The watchdog is deliberately PURE POLICY -- it never touches engines, state
or disk.  The runner feeds it one observation per completed training step
(from the in-step health probe, ``guardian/probe.py``, with the same
one-step lag the NaN-abort check already uses) and acts on the returned
decision:

- ``"rollback"``   sustained divergence: restore the last-known-good
  snapshot, perturb the RNG, climb one escalation rung (``escalate.py``);
- ``"recovered"``  the run stayed healthy for ``recover`` steps after a
  rollback: the regression is over, log it and re-arm;
- ``None``         keep training.

Divergence has two modes with different urgencies: a NON-FINITE loss means
the parameters are already poisoned (every later step is garbage), so it
triggers immediately and ignores the cooldown; a finite loss SPIKE
(``spike`` x the EMA reference, probe.py) must persist for ``patience``
consecutive steps, and after a rollback the spike trigger backs off
exponentially (``patience * backoff^attempt`` steps) so each escalated
configuration gets a growing grace window to prove itself while replaying
the regime that broke its predecessor.  ``retries`` bounds the total
rollback count; past it the runner declares the run failed.

``observe_timeouts`` and ``observe_ceiling`` are the policy for the
bounded-wait timeouts and the deadline controller's ceiling, which the
port does not carry yet; they are kept whole so that those planes can
call them when they land.
"""

import math

from ..obs import events, trace
from ..utils import parse_keyval
from .escalate import DEFAULT_LADDER, EscalationLadder


class GuardianConfig:
    """Parsed ``--guardian-args`` (key:value strings, like every registry).

    Keys: ``patience`` (consecutive spiked steps before rollback, default 3),
    ``spike`` (loss/EMA ratio counted as a spike, default 25), ``retries``
    (max rollbacks before the run is declared failed, default 5), ``backoff``
    (cooldown growth base, default 2), ``recover`` (healthy steps after a
    rollback before declaring recovery, default 10), ``ceiling-patience``
    (consecutive controller-at-ceiling steps before rollback, default
    4 x patience — see ``observe_ceiling``), ``ladder`` (escalation
    rungs, comma-separated — see ``escalate.py`` for the grammar)."""

    DEFAULTS = {
        "patience": 3,
        "spike": 25.0,
        "retries": 5,
        "backoff": 2.0,
        "recover": 10,
        "ceiling-patience": 0,  # 0 = derive as 4 x patience
        "ladder": DEFAULT_LADDER,
    }

    def __init__(self, args=None):
        from ..utils import UserException

        kv = parse_keyval(args or [], dict(self.DEFAULTS), strict=True)
        self.patience = int(kv["patience"])
        self.spike_factor = float(kv["spike"])
        self.retries = int(kv["retries"])
        self.backoff = float(kv["backoff"])
        self.recover_after = int(kv["recover"])
        # sustained controller-at-ceiling is chronic, not acute: give it a
        # longer leash than the loss-spike patience by default
        self.ceiling_patience = int(kv["ceiling-patience"]) or 4 * self.patience
        if self.ceiling_patience < 1:
            raise UserException(
                "guardian ceiling-patience must be >= 1 (got %d)"
                % self.ceiling_patience
            )
        if self.patience < 1:
            raise UserException("guardian patience must be >= 1 (got %d)" % self.patience)
        if self.spike_factor <= 1.0:
            raise UserException(
                "guardian spike must exceed 1 (a ratio of 1 is a flat loss), got %g"
                % self.spike_factor
            )
        if self.retries < 1:
            raise UserException("guardian retries must be >= 1 (got %d)" % self.retries)
        if self.backoff < 1.0:
            raise UserException("guardian backoff must be >= 1 (got %g)" % self.backoff)
        if self.recover_after < 1:
            raise UserException("guardian recover must be >= 1 (got %d)" % self.recover_after)
        self.ladder = EscalationLadder(kv["ladder"])


class Watchdog:
    """Consumes per-step probe readings, emits rollback/recovered decisions."""

    def __init__(self, config):
        self.config = config
        self.attempts = 0          # rollbacks performed so far
        self.unhealthy_streak = 0  # consecutive spiked/non-finite steps
        self.healthy_streak = 0    # consecutive clean steps
        self.recovering = False    # between a rollback and its recovery call
        self.cooldown_until = -1   # spike triggers suppressed below this step
        self.last_reason = None    # human-readable cause of the last rollback
        self.timeout_streak = 0    # consecutive steps with timeouts beyond f
        self.ceiling_streak = 0    # consecutive steps controller-at-ceiling
        #: the journal record of the last guardian_rollback_decision —
        #: note_rollback cites it as the guardian_rollback's cause (the
        #: causal plane: the actuation points at the decision that forced
        #: it, same-journal, so ``instance`` stays None in the reference)
        self._last_decision = None

    @property
    def healthy(self):
        """True when the last observed step was clean — the runner pins a
        snapshot as last-known-good only when this holds at save time."""
        return self.unhealthy_streak == 0

    @property
    def exhausted(self):
        return self.attempts >= self.config.retries

    def observe(self, step, loss, finite, spike):
        """One completed step's probe scalars.  Returns ``"rollback"``,
        ``"recovered"``, or ``None``."""
        finite = bool(finite)
        unhealthy = (not finite) or (spike > self.config.spike_factor)
        if not unhealthy:
            self.healthy_streak += 1
            self.unhealthy_streak = 0
            if self.recovering and self.healthy_streak >= self.config.recover_after:
                self.recovering = False
                trace.instant("guardian.recovered", cat="guardian", step=int(step),
                              attempts=self.attempts)
                events.emit("guardian_recovered", step=step,
                            attempts=self.attempts,
                            healthy_streak=self.healthy_streak)
                return "recovered"
            return None
        self.unhealthy_streak += 1
        self.healthy_streak = 0
        if not finite:
            # params are poisoned: no cooldown, no patience
            self.last_reason = "non-finite loss at step %d" % step
            trace.instant("guardian.rollback_decision", cat="guardian",
                          step=int(step), reason="non-finite")
            self._last_decision = events.emit(
                "guardian_rollback_decision", step=step, reason="non-finite")
            return "rollback"
        if step >= self.cooldown_until and self.unhealthy_streak >= self.config.patience:
            self.last_reason = (
                "loss spike x%.1f sustained %d steps (threshold x%.1f, patience %d)"
                % (spike, self.unhealthy_streak, self.config.spike_factor,
                   self.config.patience)
            )
            trace.instant("guardian.rollback_decision", cat="guardian",
                          step=int(step), reason="spike", spike=float(spike))
            self._last_decision = events.emit(
                "guardian_rollback_decision", step=step,
                reason="spike", spike=float(spike),
                streak=self.unhealthy_streak)
            return "rollback"
        return None

    def observe_timeouts(self, step, nb_timeouts, budget):
        """Bounded-wait escalation input (parallel/bounded.py): timeouts
        BEYOND the declared-f budget spend guarantee the rule does not
        have — sustained for ``patience`` steps (and outside the rollback
        cooldown, like the spike trigger) that is a rollback decision, and
        the ladder's ``f+K`` rung re-sizes the budget for the observed
        tail.  Timeouts within budget are the protocol working as designed
        and reset the streak."""
        if nb_timeouts <= budget:
            self.timeout_streak = 0
            return None
        self.timeout_streak += 1
        if step >= self.cooldown_until and self.timeout_streak >= self.config.patience:
            self.last_reason = (
                "straggler timeouts (%d) beyond the declared budget f=%d "
                "sustained %d steps" % (nb_timeouts, budget, self.timeout_streak)
            )
            trace.instant("guardian.rollback_decision", cat="guardian",
                          step=int(step), reason="straggler_timeouts",
                          nb_timeouts=int(nb_timeouts), budget=int(budget))
            self._last_decision = events.emit(
                "guardian_rollback_decision", step=step,
                reason="straggler_timeouts",
                nb_timeouts=int(nb_timeouts), budget=int(budget),
                streak=self.timeout_streak)
            return "rollback"
        return None

    def observe_ceiling(self, step, at_ceiling):
        """Adaptive-deadline escalation input (parallel/deadline.py): a
        controller pinned at its CEILING means the observed arrival tail
        wants a wider window than the operator budgeted — the fleet's tail
        has outgrown the declared deadline, a capacity regression the same
        way over-budget timeouts are.  Sustained for ``ceiling-patience``
        steps (and outside the rollback cooldown) that is a rollback
        decision; the ladder's ``f+K`` rung re-sizes the budget so more of
        the tail may be dropped instead of waited on.  Any un-pinned step
        resets the streak."""
        if not at_ceiling:
            self.ceiling_streak = 0
            return None
        self.ceiling_streak += 1
        if (step >= self.cooldown_until
                and self.ceiling_streak >= self.config.ceiling_patience):
            self.last_reason = (
                "deadline controller pinned at its ceiling for %d steps "
                "(the arrival tail outgrew the budgeted window)"
                % self.ceiling_streak
            )
            trace.instant("guardian.rollback_decision", cat="guardian",
                          step=int(step), reason="deadline_ceiling",
                          streak=int(self.ceiling_streak))
            self._last_decision = events.emit(
                "guardian_rollback_decision", step=step,
                reason="deadline_ceiling",
                streak=int(self.ceiling_streak))
            return "rollback"
        return None

    def note_rollback(self, restore_step):
        """Record that the runner executed a rollback landing at
        ``restore_step``; returns the 0-based attempt index (= the
        escalation rung to climb).  The spike cooldown grows exponentially
        with the attempt count — each escalated configuration gets a longer
        window to replay the hostile regime before being judged."""
        attempt = self.attempts
        self.attempts += 1
        self.unhealthy_streak = 0
        self.healthy_streak = 0
        self.timeout_streak = 0
        self.ceiling_streak = 0
        self.recovering = True
        grace = math.ceil(self.config.patience * self.config.backoff ** self.attempts)
        self.cooldown_until = restore_step + grace
        trace.instant("guardian.rollback", cat="guardian",
                      restore_step=int(restore_step), attempt=attempt,
                      cooldown_until=int(self.cooldown_until))
        decision, self._last_decision = self._last_decision, None
        events.emit("guardian_rollback", step=restore_step,
                    reason=self.last_reason, attempt=attempt,
                    cooldown_until=int(self.cooldown_until),
                    cause=(events.cause_of(decision)
                           if decision is not None else None))
        return attempt
