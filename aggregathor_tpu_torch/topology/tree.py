"""The host plane of the aggregation tree: per-level bounded wait, chained
custody, redundant reconstruction.

Counterpart of ``aggregathor_tpu/topology/tree.py``.  ``gars/tree.py`` is
the tree's numerics, run in the step's aggregate; this module is the tree's
protocol, driven once a round by ``parallel/bounded.py``:

- **Per-level bounded wait.**  Each level is a round of its own with its own
  :class:`~aggregathor_tpu_torch.parallel.deadline.DeadlineController`: a
  unit arrives at the latest of its children's effective arrivals plus the
  level's measured emission time plus any injected stall (chaos
  ``straggle-agg``).  A unit past its level's window times out as a unit.
- **Redundant reconstruction** (CodedReduce, arXiv:1902.01981).  With
  ``redundancy=r`` each group is computed by its primary and r - 1 sibling
  units; honest shadows compute the same summary from the same rows, so a
  faulted primary is served by its first live shadow at no cost.  With no
  live shadow the subtree is excluded: its leaf workers' ``arrived`` and
  ``stale`` flags are cleared, the aggregate NaN-masks them, and the
  level's budget (``agg-f``) is spent.
- **Chained custody.**  Every unit HMAC-signs the digest of the summaries it
  emitted (per-(level, unit) keys under the ``b"topology"`` context); the
  root verifies every tag and folds them into a rolling chain head,
  ``SHA-256(head || step || level || tags || verdicts)``.  A failed tag
  names the (level, unit): ``topology_corruption_verdict`` in the journal,
  ``note_subaggregator`` in forensics.  The chaos ``corrupt-agg`` fault is a
  unit that signs without the session secret (an impersonator).

The emissions are the card's part: level 0 decodes the leaf wire through
the worker codec and NaN-masks the rows that neither arrived nor are stale,
then every level runs ``gars.tree.level_pass``, the code and keys of the
step's in-graph ``tree`` rule (the centring and K2 where a rule needs
distances, K3-K6 for a coordinate-wise one, the inter-level link), and
``row_digest`` on its summaries, so the chain signs exactly what the
aggregate consumes.  JAX jits one executable a level; the port runs eagerly,
and :meth:`TreeAggregator.cache_size` counts the input shapes each level
has run (1 in steady state).  Keys are int seeds, as the ``tree`` rule's:
the bounded step passes the step's GAR key (JAX keys the emissions with
``PRNGKey(step)``, trap c).

:meth:`TreeAggregator.resolve_round` is the pure decision core (arrivals
in, verdicts out: no devices, no sleeps, no wall clock); the chaos stalls
are arithmetic on the arrival vectors.
"""

import hashlib
import struct
import time

import numpy as np
import torch

from ..gars.tree import level_pass
from ..obs import events
from ..parallel.auth import GradientAuthenticator
from ..parallel.deadline import DeadlineController
from ..secure.submit import FORGER_SECRET, digest_to_bytes, row_digest
from ..utils import UserException

#: what an unsecured tree signs with: custody needs some key material for
#: the chain head to be defined; detecting a forgery needs ``--session-secret``
DEFAULT_TOPOLOGY_SECRET = b"aggregathor-topology-default-secret"


class TreeAggregator:
    """The tree protocol's driver, one a run (it outlives the guardian's
    rebuilds, as the deadline controller does).

    Args:
      spec: a validated :class:`~aggregathor_tpu_torch.topology.spec.TreeSpec`.
      registry: optional ``MetricsRegistry``: per-level seconds, timeouts,
        reconstructions, corruptions, exclusions, link bytes, rounds and the
        link's compression ratio.
      session_secret: custody key material (bytes); None signs with
        :data:`DEFAULT_TOPOLOGY_SECRET`.
      deadline: initial per-level window (seconds); None disables the level
        deadlines (only injected stalls and custody verdicts fault a unit).
      deadline_opts: the ``DeadlineController`` knobs (percentile, floor,
        ceiling, ema) every level's controller shares.

    Attached after construction: ``ledger`` (a ``ForensicsLedger``) and
    ``schedule`` (a ``ChaosSchedule`` read each round for its
    ``corrupt-agg``/``straggle-agg`` targets).
    """

    def __init__(self, spec, registry=None, session_secret=None, deadline=None, deadline_opts=None):
        self.spec = spec
        self.ledger = None
        self.schedule = None
        secret = session_secret or DEFAULT_TOPOLOGY_SECRET
        self.auth = GradientAuthenticator(secret, spec.total_units, context=b"topology")
        self._forger = GradientAuthenticator(FORGER_SECRET, spec.total_units, context=b"topology")
        self._chain = hashlib.sha256(b"aggregathor-topology-chain-v1").digest()
        self._chain_steps = 0
        self.controllers = None
        if deadline is not None:
            opts = dict(deadline_opts or {})
            self.controllers = [DeadlineController(deadline, **opts) for _ in range(spec.nb_levels)]
        # bound by the BoundedWaitStep that drives this tree (bind())
        self._d = None
        self._codec = None
        self._shapes = None
        self._warm = False
        self.rounds_total = 0
        self._c_seconds = self._c_timeouts = self._c_reconstructions = None
        self._c_corruptions = self._c_exclusions = self._c_bytes = None
        self._c_rounds = self._g_ratio = None
        if registry is not None:
            self._c_seconds = registry.counter("topology_level_seconds_total",
                                               "Cumulative per-level sub-aggregation wall time",
                                               labelnames=("level",))
            self._c_timeouts = registry.counter("topology_level_timeouts_total",
                                                "Sub-aggregator units that missed their level window",
                                                labelnames=("level",))
            self._c_reconstructions = registry.counter("topology_reconstructions_total",
                                                       "Faulted units served by a redundant sibling shadow",
                                                       labelnames=("level",))
            self._c_corruptions = registry.counter("topology_corruptions_total",
                                                   "Units whose custody tag failed chain verification",
                                                   labelnames=("level",))
            self._c_exclusions = registry.counter("topology_exclusions_total",
                                                  "Faulted units with no live shadow — whole subtree "
                                                  "excluded (NaN row, budget spent)", labelnames=("level",))
            self._c_bytes = registry.counter("topology_bytes_on_wire_total",
                                             "Bytes shipped on the inter-level links (all redundant "
                                             "copies counted)", labelnames=("level",))
            self._c_rounds = registry.counter("topology_rounds_total", "Tree aggregation rounds processed")
            self._g_ratio = registry.gauge("topology_link_compression_ratio",
                                           "Inter-level link compression ratio vs the f32 wire")

    # ------------------------------------------------------------------ #
    # binding (BoundedWaitStep construction time)

    def bind(self, nb_workers, d, codec=None):
        """Bind the leaf plane: the flattened row width and the worker
        exchange codec (the leaf links' wire; the tree's own wire is
        ``spec.link_*``).  Called once by the driving BoundedWaitStep."""
        if nb_workers != self.spec.nb_workers:
            raise UserException("topology tree is sized for n=%d but the engine runs n=%d"
                                % (self.spec.nb_workers, nb_workers))
        self._d = int(d)
        self._codec = codec
        if self.spec.link_codec is not None:
            self.spec.link_codec.validate_d(self._d)
        if self._g_ratio is not None:
            self._g_ratio.set(self.spec.link_ratio(self._d))
        self._shapes = [set() for _ in range(self.spec.nb_levels)]

    def _leaf_rows(self, rows, valid):
        """Level 0's input: the leaf wire decoded, NaN where a worker
        neither arrived nor is stale (the aggregate's convention)."""
        if self._codec is not None:
            rows = self._codec.decode(rows, self._d)
        else:
            rows = rows.to(torch.float32)
        return torch.where(valid[:, None], rows, torch.nan)

    @torch.no_grad()
    def emit_level(self, level, rows, key):
        """Level ``level``'s (0-based) emission: child rows in, ``(summaries
        (m, d), digests (m, DIGEST_LANES) uint32)`` out, on the rows' device."""
        self._shapes[level].add((tuple(rows.shape), rows.dtype, rows.device))
        summaries, _ = level_pass(self.spec, level, rows, key)
        return summaries, row_digest(summaries)

    def emissions(self, rows_in, valid, key=None):
        """Every level's ``(summaries, host digests, seconds)`` for one
        round's stacked leaf wire ``rows_in`` and (n,) bool ``valid``; the
        seconds include the digests' copy to the host."""
        if self._shapes is None:
            raise UserException("TreeAggregator.process_round before bind() — the driving BoundedWaitStep binds "
                                "the leaf plane at construction")
        valid = torch.as_tensor(np.asarray(valid, bool)).to(self._device(rows_in))
        out = []
        rows = None
        for level in range(self.spec.nb_levels):
            begin = time.perf_counter()
            rows = self._leaf_rows(rows_in, valid) if level == 0 else rows
            rows, digests = self.emit_level(level, rows, key)
            digests = digests.cpu().numpy()
            out.append((rows, digests, time.perf_counter() - begin))
        return out

    @staticmethod
    def _device(rows):
        if isinstance(rows, dict):
            return next(iter(rows.values())).device
        return rows.device

    # ------------------------------------------------------------------ #
    # the pure decision core (synthetic-clock tests drive this directly)

    def resolve_round(self, step, child_arrivals, compute_seconds, corrupt_units=(), straggle_units=(),
                      windows=None):
        """One round's per-level verdicts: pure arithmetic, no devices (JAX
        ``tree.py:244-362``).

        The clock is absolute (zero = the leaf round's open).  Level l's
        round opens when level l - 1's closes (at its last effective
        arrival), and its window judges arrivals relative to that open: a
        unit whose children all arrived early arrives at 0, and a unit
        excluded at level l - 1 charges that level's window, never its
        parent's (no cascade up the root path).

        Args:
          step: the training step.
          child_arrivals: (n,) finite effective leaf arrivals (the caller
            caps the leaf timeouts at the leaf window).
          compute_seconds: per-level measured emission seconds.
          corrupt_units: (level, unit) pairs whose custody tag failed
            (1-based level).
          straggle_units: (level, unit) pairs with an injected stall: the
            unit's arrival becomes +inf.
          windows: per-level windows (None entries disable a level's
            deadline); default the controllers' live windows.

        Returns one dict a level: ``{level, window, arrivals, timed_out,
        corrupt, reconstructed: {unit: shadow}, excluded: [unit, ...]}``,
        ``arrivals`` the round-relative arrivals the level's controller
        observes.
        """
        spec = self.spec
        if windows is None:
            if self.controllers is not None:
                windows = [c.window for c in self.controllers]
            else:
                windows = [None] * spec.nb_levels
        corrupt_units = set((int(lv), int(u)) for lv, u in corrupt_units)
        straggle_units = set((int(lv), int(u)) for lv, u in straggle_units)
        arrivals = np.asarray(child_arrivals, np.float64).reshape(-1)
        close = float(arrivals.max()) if arrivals.size else 0.0
        verdicts = []
        for index in range(spec.nb_levels):
            level = index + 1
            g = spec.group_sizes[index]
            m = spec.nb_units[index]
            window = windows[index]
            # a unit starts when its last child lands and takes the level's
            # measured compute, plus any injected stall
            avail = arrivals.reshape(m, g).max(axis=1) + float(compute_seconds[index])
            for (lv, u) in straggle_units:
                if lv == level:
                    avail[u] = np.inf
            finite = np.isfinite(avail)
            relative = np.maximum(avail - close, 0.0)
            if window is None:
                timed_out = ~finite
            else:
                timed_out = ~finite | (relative > window)
            corrupt = np.zeros((m,), bool)
            for (lv, u) in corrupt_units:
                if lv == level:
                    corrupt[u] = True
            faulted = timed_out | corrupt
            # the first live shadow serves, else the subtree is excluded; a
            # shadow faulted this round cannot serve
            reconstructed = {}
            excluded = []
            for unit in np.nonzero(faulted)[0]:
                shadow = next((s for s in spec.shadows(level, int(unit)) if not faulted[s]), None)
                if shadow is not None:
                    reconstructed[int(unit)] = int(shadow)
                else:
                    excluded.append(int(unit))
            # the level's absolute close: a clean unit at its availability
            # (capped at the window's close), a reconstructed one at its
            # shadow's, an excluded one at the whole window
            if window is not None:
                cap = close + float(window)
            elif finite.any():
                cap = float(avail[finite].max())
            else:
                cap = close + float(compute_seconds[index])
            effective = np.minimum(np.where(finite, avail, cap), cap)
            for unit, shadow in reconstructed.items():
                effective[unit] = effective[shadow]
            for unit in excluded:
                effective[unit] = cap
            verdicts.append({"level": level, "window": window, "arrivals": relative, "timed_out": timed_out,
                             "corrupt": corrupt, "reconstructed": reconstructed, "excluded": excluded})
            arrivals = effective
            close = float(effective.max()) if effective.size else close
        return verdicts

    # ------------------------------------------------------------------ #
    # the per-round protocol (driven by parallel/bounded.py)

    def process_round(self, step, arrived, stale, arrival_seconds, rows_in, leaf_window=None, key=None):
        """One completed leaf round through the tree: the emissions, custody,
        the per-level bounded wait, reconstruction and exclusion (JAX
        ``tree.py:364-540``).  ``rows_in`` is the stacked leaf wire (the
        codec's payload dict under a codec), ``key`` the step's GAR key.
        Returns the updated ``(arrived, stale)`` masks, excluded subtrees
        cleared."""
        spec = self.spec
        emitted = self.emissions(rows_in, np.asarray(arrived, bool) | np.asarray(stale, bool), key)
        arrived = np.asarray(arrived).astype(bool).copy()
        stale = np.asarray(stale).astype(bool).copy()

        regime = None
        if self.schedule is not None:
            regime = self.schedule.regimes[self.schedule.regime_at(step)]
        corrupt_targets = set(getattr(regime, "agg_corrupt", ()) or ())
        straggle_targets = tuple(getattr(regime, "agg_straggle", ()) or ())

        compute_seconds = []
        for index, (_, _, seconds) in enumerate(emitted):
            compute_seconds.append(seconds)
            if self._c_seconds is not None:
                self._c_seconds.labels(level=str(index + 1)).inc(seconds)

        # custody: every unit signs its emission's digest, the root verifies
        corrupt_units = []
        for index, (_, digests, _) in enumerate(emitted):
            level = index + 1
            tags = []
            verdicts = []
            for unit in range(spec.nb_units[index]):
                idx = spec.unit_index(level, unit)
                payload = digest_to_bytes(digests[unit])
                if (level, unit) in corrupt_targets:
                    # the chaos fault: this unit signs without the session secret
                    tag = self._forger.sign(idx, int(step), payload)
                else:
                    tag = self.auth.sign(idx, int(step), payload)
                ok = self.auth.verify(idx, int(step), payload, tag)
                tags.append(tag)
                verdicts.append(ok)
                if not ok:
                    corrupt_units.append((level, unit))
                    if self._c_corruptions is not None:
                        self._c_corruptions.labels(level=str(level)).inc()
            self._chain = hashlib.sha256(self._chain + struct.pack("<qq", int(step), level) + b"".join(tags)
                                         + np.asarray(verdicts, bool).tobytes()).digest()
        self._chain_steps += 1

        # the per-level bounded wait over the synthetic and measured clock
        arrival_seconds = np.asarray(arrival_seconds, np.float64)
        if leaf_window is not None:
            cap = float(leaf_window)
        elif np.isfinite(arrival_seconds).any():
            cap = float(arrival_seconds[np.isfinite(arrival_seconds)].max())
        else:
            cap = 0.0
        leaf_arrivals = np.where(np.isfinite(arrival_seconds), arrival_seconds, cap)
        warm = self._warm
        self._warm = True
        windows = None
        if not warm or self.controllers is None:
            # the first round builds the kernels: charging that to the level
            # windows would fault every unit of round 0 (injected stalls
            # still resolve: inf beats any window)
            windows = [None] * spec.nb_levels
        verdicts = self.resolve_round(step, leaf_arrivals, compute_seconds, corrupt_units=corrupt_units,
                                      straggle_units=straggle_targets, windows=windows)

        for verdict in verdicts:
            level = verdict["level"]
            index = level - 1
            if self.controllers is not None and warm:
                censored = np.where(verdict["timed_out"], np.inf, verdict["arrivals"])
                self.controllers[index].observe_round(censored, step=step)
            if self._c_bytes is not None:
                self._c_bytes.labels(level=str(level)).inc(
                    spec.nb_units[index] * spec.redundancy * spec.link_bytes_per_row(self._d))
            # each unit's conviction of this level round: the reconstruction
            # event cites it as its cause
            convictions = {}
            for unit in np.nonzero(verdict["timed_out"])[0]:
                unit = int(unit)
                excluded = unit in verdict["excluded"]
                if self._c_timeouts is not None:
                    self._c_timeouts.labels(level=str(level)).inc()
                convictions[unit] = events.emit(
                    "topology_level_timeout", step=int(step), level=level, unit=unit,
                    window=None if verdict["window"] is None else float(verdict["window"]),
                    excluded=excluded, cause=None)
                if self.ledger is not None:
                    self.ledger.note_subaggregator(step, level, unit, "timeout", {"excluded": excluded})
            for unit in np.nonzero(verdict["corrupt"])[0]:
                unit = int(unit)
                excluded = unit in verdict["excluded"]
                convictions[unit] = events.emit("topology_corruption_verdict", step=int(step), level=level,
                                                unit=unit, excluded=excluded, cause=None)
                if self.ledger is not None:
                    self.ledger.note_subaggregator(step, level, unit, "forgery", {"excluded": excluded})
            for unit, shadow in verdict["reconstructed"].items():
                trigger = "forgery" if verdict["corrupt"][unit] else "timeout"
                if self._c_reconstructions is not None:
                    self._c_reconstructions.labels(level=str(level)).inc()
                conviction = convictions.get(int(unit))
                events.emit("topology_reconstruction", step=int(step), level=level, unit=int(unit),
                            shadow=int(shadow), trigger=trigger,
                            cause=events.cause_of(conviction) if conviction is not None else None)
                if self.ledger is not None:
                    self.ledger.note_subaggregator(step, level, unit, "reconstructed",
                                                   {"shadow": int(shadow), "cause": trigger})
            for unit in verdict["excluded"]:
                if self._c_exclusions is not None:
                    self._c_exclusions.labels(level=str(level)).inc()
                span = spec.leaf_span(level, unit)
                arrived[span.start:span.stop] = False
                stale[span.start:span.stop] = False
        self.rounds_total += 1
        if self._c_rounds is not None:
            self._c_rounds.inc()
        return arrived, stale

    # ------------------------------------------------------------------ #

    def chain(self):
        """The custody chain's lineage (the tree's twin of
        ``SubmissionAuthenticator.chain()``)."""
        return {"head": self._chain.hex(), "steps": self._chain_steps, "nb_units": self.spec.total_units}

    def cache_size(self):
        """The most input shapes any level's emission has run: 1 in steady
        state (JAX: the most compiles of a level's executable)."""
        if not self._shapes:
            return 0
        return max(len(shapes) for shapes in self._shapes)
