"""Adaptive bounded-wait deadlines: a percentile controller over arrivals.

Counterpart of ``aggregathor_tpu/parallel/deadline.py``, a copy: numpy only,
its windows the JAX controller's bits (``tests/test_torch_deadline.py``).

The fixed bounded-wait protocol closes every round at a FIXED
``--step-deadline``.  Under a drifting or bimodal straggler regime that
forces a bad trade: a window sized for the tail wastes the common case
(every quiet round still waits the full deadline before giving up on a
genuinely dead worker), while a window sized for the common case throws
away the whole tail.  OptiReduce (arXiv:2310.06993) shows the win comes
from ADAPTIVE time windows; this module is that controller, host-side pure
policy in the watchdog's style (guardian/watchdog.py): it never touches
engines or clocks, it just consumes one arrival vector per round and emits
the next round's window.

Control law, per completed round:

1. The round's per-worker arrival times (seconds from round open to row
   materialization; a worker that missed the window is CENSORED — observed
   only as "later than the window") feed a target: the
   ``percentile``-th percentile of the arrival vector with censored
   entries read as ``+inf``.  If the percentile rank touches a censored
   entry the round's target is the ``ceiling`` — the controller widens
   when it cannot see the tail it is asked to cover.
2. The window moves by an EMA, ``w <- (1 - ema) * w + ema * target``, so
   a single spiked round cannot whipsaw the window (``ema`` is the weight
   of the NEW observation).
3. The result clamps into ``[floor, ceiling]``.  ``at_ceiling`` exposes a
   pinned controller — the last round's DEMANDED target hit the ceiling
   (the EMA'd window only asymptotically approaches it, so the window
   itself would under-report a pinned tail for dozens of rounds) — which
   the guardian treats as an escalation input
   (``Watchdog.observe_ceiling``, docs/guardian.md).

Choosing ``percentile``: a coalition of ``s`` PERSISTENT stragglers
censors ``s/n`` of every round, so any percentile above
``100 * (n - s - 1) / (n - 1)`` reads censored forever and pins the
window at the ceiling (the rank ``P/100 * (n-1)`` interpolates, so its
CEILED neighbor must stay below the censored mass).  Set it at or below
that bound with ``s = f`` — ``100 * (n - f - 1) / (n - 1)``, e.g. 71.4
for n=8, f=2 — and the window converges down to the honest arrivals
instead (the adaptive win the straggler sweep measures,
benchmarks/straggler_sweep.py).

Everything here is deterministic in the observed arrivals — the
percentile/EMA/clamp math is pinned against synthetic traces by
tests/test_deadline.py and tests/test_torch_deadline.py, no wall clock
involved.
"""

import numpy as np

from ..obs import events
from ..utils import UserException

#: arrival-seconds histogram buckets (sub-ms to tens of seconds — the
#: whole range a host-clock round can span)
ARRIVAL_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class DeadlineController:
    """Percentile/EMA/clamp window controller for bounded-wait rounds.

    Args:
      initial: starting window (seconds); clamped into [floor, ceiling].
      percentile: target arrival percentile in (0, 100] the window tracks.
      floor: smallest window the controller may emit (> 0 — a zero window
        would time out every worker of every round).
      ceiling: largest window (defaults to ``initial``) — the operator's
        declared worst-case wait, i.e. what ``--step-deadline`` meant
        under the fixed protocol.
      ema: weight of each new round's target in (0, 1]; 1 disables
        smoothing.
      registry: optional ``MetricsRegistry`` — per-worker arrival
        histograms (``bounded_wait_arrival_seconds{worker=}``), the live
        window gauge (``deadline_controller_window_seconds``), a pinned
        flag (``deadline_controller_at_ceiling``) and the censored-round
        counter (``deadline_controller_censored_rounds_total``).
    """

    def __init__(self, initial, percentile=90.0, floor=0.01, ceiling=None,
                 ema=0.3, registry=None):
        if initial is None or initial <= 0.0:
            raise UserException(
                "the deadline controller needs an initial window > 0 "
                "seconds (--step-deadline)"
            )
        self.percentile = float(percentile)
        if not 0.0 < self.percentile <= 100.0:
            raise UserException(
                "--deadline-percentile must lie in (0, 100], got %g"
                % self.percentile
            )
        self.floor = float(floor)
        if self.floor <= 0.0:
            raise UserException(
                "--deadline-floor must be > 0 seconds (a zero window times "
                "out every worker), got %g" % self.floor
            )
        self.ceiling = float(ceiling) if ceiling is not None else float(initial)
        if self.ceiling < self.floor:
            raise UserException(
                "--deadline-ceiling (%g) must be >= --deadline-floor (%g)"
                % (self.ceiling, self.floor)
            )
        self.ema = float(ema)
        if not 0.0 < self.ema <= 1.0:
            raise UserException(
                "--deadline-ema must lie in (0, 1] (the weight of each new "
                "round's target), got %g" % self.ema
            )
        self._window = float(np.clip(initial, self.floor, self.ceiling))
        # before any observation the demand signal falls back to the
        # window itself (an initial == ceiling reads pinned until the
        # first round proves otherwise)
        self._demand_at_ceiling = self._window >= self.ceiling * (1.0 - 1e-9)
        self.rounds_observed = 0
        self.censored_rounds = 0
        self._h_arrival = self._g_window = None
        self._g_ceiling = self._c_censored = None
        if registry is not None:
            self._h_arrival = registry.histogram(
                "bounded_wait_arrival_seconds",
                "Per-worker submission arrival time within a round",
                labelnames=("worker",), buckets=ARRIVAL_BUCKETS,
            )
            self._g_window = registry.gauge(
                "deadline_controller_window_seconds",
                "Adaptive bounded-wait window for the next round",
            )
            self._g_ceiling = registry.gauge(
                "deadline_controller_at_ceiling",
                "1 while the last round's demanded target sat at the "
                "window ceiling",
            )
            self._c_censored = registry.counter(
                "deadline_controller_censored_rounds_total",
                "Rounds whose target percentile fell among censored "
                "(timed-out) arrivals",
            )
            self._g_window.set(self._window)
            self._g_ceiling.set(float(self.at_ceiling))

    @property
    def window(self):
        """The window (seconds) the NEXT round should close at."""
        return self._window

    @property
    def at_ceiling(self):
        """True while the last round's DEMANDED target sat at/over the
        ceiling — the observed tail wants more than the budgeted window
        (escalation input).  Deliberately not the EMA'd window: the EMA
        only asymptotically approaches the ceiling (>= 58 rounds to close
        a 1e-9 gap at ema 0.3), which would stall the guardian's
        ceiling-patience streak far past its documented length."""
        return self._demand_at_ceiling

    def observe_round(self, arrival_seconds, step=None, unit_size=1):
        """Feed one completed round; returns the updated window.

        ``arrival_seconds`` is the (n,) per-worker arrival vector: seconds
        from round open to row materialization, with non-finite entries
        (NaN/inf) for workers that missed the round's window (censored).
        ``step`` (optional) stamps the journal's ``deadline_window`` events
        — emitted only when the window MOVES materially, censors, or flips
        its at-ceiling verdict, so the journal stays a decision timeline,
        not a per-round metrics mirror.

        ``unit_size`` (bounded-wait v3): the number of logical workers per
        SUBMISSION UNIT.  A grouped round's k members share one arrival
        instant by construction (the submesh arrives — or forfeits — as a
        whole), so the percentile votes over the W per-unit arrivals
        (every k-th entry) instead of k duplicated copies; the per-worker
        histograms keep their full labels.
        """
        arrivals = np.asarray(arrival_seconds, np.float64).reshape(-1)
        finite = np.isfinite(arrivals)
        if self._h_arrival is not None:
            for worker in np.nonzero(finite)[0]:
                self._h_arrival.labels(worker=str(int(worker))).observe(
                    float(arrivals[worker])
                )
        unit_size = int(unit_size)
        if unit_size > 1:
            if arrivals.size % unit_size:
                raise UserException(
                    "observe_round: %d arrivals do not group into units "
                    "of %d" % (arrivals.size, unit_size)
                )
            arrivals = arrivals[::unit_size]
            finite = finite[::unit_size]
        censored = np.sort(np.where(finite, arrivals, np.inf))
        # linear-interpolated percentile, computed by hand so a censored
        # (+inf) upper neighbor reads as "censored" instead of an inf-inf
        # NaN from np.percentile's interpolation
        rank = self.percentile / 100.0 * (censored.size - 1)
        lo, hi = int(np.floor(rank)), int(np.ceil(rank))
        if np.isfinite(censored[hi]):
            frac = rank - lo
            target = float((1.0 - frac) * censored[lo] + frac * censored[hi])
        else:
            target = np.inf
        censored_round = not np.isfinite(target)
        if censored_round:
            # the percentile rank touched a censored arrival: the tail the
            # controller is asked to cover is beyond what it observed, so
            # the round votes for the widest window it is allowed
            target = self.ceiling
            self.censored_rounds += 1
            if self._c_censored is not None:
                self._c_censored.inc()
        # demand, judged on the UNCLAMPED pre-EMA target: the escalation
        # streak must begin the round the tail outgrows the budget
        was_at_ceiling = self._demand_at_ceiling
        previous_window = self._window
        self._demand_at_ceiling = target >= self.ceiling * (1.0 - 1e-9)
        self._window = float(np.clip(
            (1.0 - self.ema) * self._window + self.ema * target,
            self.floor, self.ceiling,
        ))
        self.rounds_observed += 1
        if self._g_window is not None:
            self._g_window.set(self._window)
            self._g_ceiling.set(float(self.at_ceiling))
        # journal (obs/events.py): window MOVES are causal decisions — a
        # material move (>1% relative or >1 ms), a censored target or an
        # at-ceiling flip lands on the timeline; the per-round jitter of
        # the EMA does not
        moved = abs(self._window - previous_window) > max(
            0.01 * previous_window, 1e-3
        )
        if moved or censored_round or was_at_ceiling != self._demand_at_ceiling:
            events.emit(
                "deadline_window", step=step,
                window_s=self._window, previous_s=previous_window,
                target_s=float(target), at_ceiling=bool(self._demand_at_ceiling),
                censored=bool(censored_round), round=int(self.rounds_observed),
            )
        return self._window
