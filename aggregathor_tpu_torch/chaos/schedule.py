"""Piecewise fault-regime schedule DSL.

Counterpart of ``aggregathor_tpu/chaos/schedule.py``: the same grammar,
gates and host arrays.  Grammar (whitespace-separated segments)::

  SCHEDULE := SEGMENT (" " SEGMENT)*
  SEGMENT  := STEP ":" REGIME            # STEP is a non-negative integer
  REGIME   := "calm" | SETTING ("," SETTING)*
  SETTING  := KEY "=" VALUE

Keys: ``attack=NAME`` (a registered attack of ``parallel/attacks``; any
other key of the regime is passed to it as ``key:value``), ``drop=RATE``
(i.i.d. packet loss on every worker's row), ``straggle=RATE`` with
``straggle-mode=drop|stale`` (``stragglers.py``) and ``jitter=SIGMA`` (the
bounded-wait host model's lognormal spread; the in-step lateness is
binary), ``forge=RATE`` and ``tamper=RATE`` (the coalition's forged and
bit-flipped submissions, consumed by secure submission), the process-plane
``kill=``/``hang=`` (refused unless ``allow_process_faults``) and the
topology-plane ``corrupt-agg=``/``straggle-agg=`` (refused unless
``allow_topology_faults``).  A ``calm`` regime has no adversity; the regime
starting at s governs the steps s <= t < next start, and an implicit
``0:calm`` comes first when no segment starts at 0.

Schedule-wide options (``--chaos-args``): ``packet-coords:N`` (the drop
link's datagram, default the UDP 65000 bytes), ``min-coords:N`` (default 0:
a storm hits every row, unlike ``--UDP``'s ~1 MB threshold) and
``straggle-workers:K`` (only workers w < K straggle; 0: all).

The JAX package indexes its host arrays with the traced step inside one
compiled program (``regime_index``); here the step is a host int, so
``regime_at(step)`` serves both and each accessor indexes a numpy array.  The
regime's attacks dispatch on that index (``apply_local_attacks``,
``apply_omniscient_attacks``).  The drop storm and the lateness are drawn
on CPU generators keyed (seed, step, w, 2) and (seed, step, w, 5)
(``draw_drops``, ``stragglers.draw_late``), and applied by separate calls.
"""

import numpy as np

from ..utils import UserException, parse_keyval
from .replica_faults import parse_process_targets

_CALM = "calm"


def parse_topology_targets(key, value):
    """``1.0+2.1`` -> ((1, 0), (2, 1)): (1-based level, 0-based unit) pairs."""
    targets = []
    for part in value.split("+"):
        pieces = part.strip().split(".")
        try:
            level, unit = (int(p) for p in pieces)
        except ValueError:
            raise UserException("Chaos %s=%r: each target must be LEVEL.UNIT (two integers, e.g. %s=1.0+2.1)"
                                % (key, value, key))
        if level < 1:
            raise UserException("Chaos %s=%r: levels are 1-based (got level %d)" % (key, value, level))
        if unit < 0:
            raise UserException("Chaos %s=%r: unit indices are >= 0 (got %d)" % (key, value, unit))
        targets.append((level, unit))
    if not targets:
        raise UserException("Chaos %s= names no targets" % key)
    return tuple(targets)


class Regime:
    """One parsed schedule segment."""

    __slots__ = ("start", "spec", "attack", "drop_rate", "straggler_rate", "straggler_stale",
                 "straggler_jitter", "forge_rate", "tamper_rate", "kills", "hangs", "agg_corrupt",
                 "agg_straggle")

    def __init__(self, start, spec, attack=None, drop_rate=0.0, straggler_rate=0.0, straggler_stale=False,
                 straggler_jitter=0.0, forge_rate=0.0, tamper_rate=0.0, kills=(), hangs=(), agg_corrupt=(),
                 agg_straggle=()):
        self.start = int(start)
        self.spec = spec
        self.attack = attack
        self.drop_rate = float(drop_rate)
        self.straggler_rate = float(straggler_rate)
        self.straggler_stale = bool(straggler_stale)
        self.straggler_jitter = float(straggler_jitter)
        self.forge_rate = float(forge_rate)
        self.tamper_rate = float(tamper_rate)
        self.kills = tuple(kills)
        self.hangs = tuple(hangs)
        self.agg_corrupt = tuple(agg_corrupt)
        self.agg_straggle = tuple(agg_straggle)


def _parse_rate(key, value):
    try:
        rate = float(value)
    except ValueError:
        raise UserException("Chaos %s=%r is not a number" % (key, value))
    if not 0.0 <= rate <= 1.0:
        raise UserException("Chaos %s=%r must lie in [0, 1]" % (key, value))
    return rate


def _parse_regime(start, text, nb_workers, nb_real_byz):
    """One REGIME body -> a :class:`Regime`."""
    from ..parallel import attacks as attack_registry

    if text == _CALM:
        return Regime(start, _CALM)
    attack_name, attack_args = None, []
    drop_rate = forge_rate = tamper_rate = 0.0
    straggler_rate = straggler_stale = straggler_jitter = None
    kills = hangs = agg_corrupt = agg_straggle = ()
    seen = set()
    for setting in text.split(","):
        if "=" not in setting:
            raise UserException("Chaos regime setting %r at step %d: expected KEY=VALUE (or the bare regime "
                                "name 'calm')" % (setting, start))
        key, value = setting.split("=", 1)
        if key in seen:
            raise UserException("Chaos regime at step %d sets %r twice" % (start, key))
        seen.add(key)
        if key == "attack":
            if value not in attack_registry.itemize():
                raise UserException("Unknown chaos attack %r (registered: %s)"
                                    % (value, ", ".join(sorted(attack_registry.itemize()))))
            attack_name = value
        elif key == "drop":
            drop_rate = _parse_rate(key, value)
        elif key == "straggle":
            straggler_rate = _parse_rate(key, value)
        elif key == "forge":
            forge_rate = _parse_rate(key, value)
        elif key == "tamper":
            tamper_rate = _parse_rate(key, value)
        elif key == "kill":
            kills = parse_process_targets(key, value)
        elif key == "hang":
            hangs = parse_process_targets(key, value)
        elif key == "corrupt-agg":
            agg_corrupt = parse_topology_targets(key, value)
        elif key == "straggle-agg":
            agg_straggle = parse_topology_targets(key, value)
        elif key == "straggle-mode":
            if value not in ("drop", "stale"):
                raise UserException("Chaos straggle-mode=%r must be 'drop' or 'stale'" % (value,))
            straggler_stale = value == "stale"
        elif key == "jitter":
            try:
                straggler_jitter = float(value)
            except ValueError:
                raise UserException("Chaos jitter=%r is not a number" % (value,))
            if straggler_jitter < 0.0:
                raise UserException("Chaos jitter=%r must be >= 0 (the lognormal sigma around the straggler "
                                    "stall)" % (value,))
        else:
            attack_args.append("%s:%s" % (key, value))
    if attack_args and attack_name is None:
        raise UserException("Chaos regime at step %d passes attack arguments (%s) without attack=NAME"
                            % (start, ", ".join(attack_args)))
    if straggler_stale is not None and straggler_rate is None:
        raise UserException("Chaos regime at step %d sets straggle-mode without straggle=RATE" % start)
    if straggler_jitter is not None and straggler_rate is None:
        raise UserException("Chaos regime at step %d sets jitter without straggle=RATE" % start)
    attack = None
    if attack_name is not None:
        if nb_real_byz < 1:
            raise UserException(
                "Chaos schedule declares attack regimes (step %d: attack=%s) but nb_real_byz is 0; pass "
                "--nb-real-byz-workers > 0 so the coalition has members" % (start, attack_name))
        attack = attack_registry.instantiate(attack_name, nb_workers, nb_real_byz, attack_args)
    if (forge_rate or tamper_rate) and nb_real_byz < 1:
        raise UserException("Chaos regime at step %d sets forge/tamper rates but nb_real_byz is 0; pass "
                            "--nb-real-byz-workers > 0 so the forging coalition has members" % start)
    return Regime(start, text, attack=attack, drop_rate=drop_rate, straggler_rate=straggler_rate or 0.0,
                  straggler_stale=bool(straggler_stale), straggler_jitter=straggler_jitter or 0.0,
                  forge_rate=forge_rate, tamper_rate=tamper_rate, kills=kills, hangs=hangs,
                  agg_corrupt=agg_corrupt, agg_straggle=agg_straggle)


class ChaosSchedule:
    """A parsed fault-regime schedule the engine consumes (see the module
    docstring): the regimes, the per-regime host arrays, the family flags
    (``has_drop``, ``has_stragglers``, ``has_forgery``, ``needs_carry``,
    ``has_local_attacks``, ``has_omniscient_attacks``, ``has_attacks``),
    the storm's ``link`` and the ``stragglers`` model."""

    def __init__(self, spec, nb_workers, nb_real_byz=0, args=None, allow_process_faults=False,
                 allow_topology_faults=False):
        from ..parallel.lossy import PACKET_COORDS, LossyLink
        from .stragglers import StragglerModel

        kv = parse_keyval(args or [], {"packet-coords": PACKET_COORDS, "min-coords": 0, "straggle-workers": 0},
                          strict=True)
        self.spec = str(spec)
        self.nb_workers = int(nb_workers)
        self.nb_real_byz = int(nb_real_byz)
        segments = self.spec.split()
        if not segments:
            raise UserException("Empty chaos schedule (expected e.g. '0:calm 500:drop=0.3')")
        regimes = []
        for segment in segments:
            if ":" not in segment:
                raise UserException("Chaos segment %r: expected STEP:REGIME (e.g. '500:drop=0.3')" % (segment,))
            step_text, regime_text = segment.split(":", 1)
            try:
                start = int(step_text)
            except ValueError:
                raise UserException("Chaos segment %r: step %r is not an integer" % (segment, step_text))
            if start < 0:
                raise UserException("Chaos segment %r: negative start step" % (segment,))
            regimes.append(_parse_regime(start, regime_text, self.nb_workers, self.nb_real_byz))
        starts = [r.start for r in regimes]
        if len(set(starts)) != len(starts):
            dup = sorted(s for s in set(starts) if starts.count(s) > 1)
            raise UserException("Chaos schedule has duplicate start steps: %s" % dup)
        regimes.sort(key=lambda r: r.start)
        if regimes[0].start != 0:
            regimes.insert(0, Regime(0, _CALM))
        self.regimes = regimes
        self.has_process_faults = any(r.kills or r.hangs for r in regimes)
        if self.has_process_faults and not allow_process_faults:
            offender = next(r for r in regimes if r.kills or r.hangs)
            raise UserException(
                "Chaos regime %d:%s declares process-level faults (kill=/hang=) but this consumer is a training "
                "engine — a training step cannot kill fleet processes.  Those keys belong to the fleet plane: "
                "benchmarks/soak.py and cli.supervise build their schedule with allow_process_faults=True"
                % (offender.start, offender.spec))
        self.has_topology_faults = any(r.agg_corrupt or r.agg_straggle for r in regimes)
        if self.has_topology_faults and not allow_topology_faults:
            offender = next(r for r in regimes if r.agg_corrupt or r.agg_straggle)
            raise UserException(
                "Chaos regime %d:%s declares sub-aggregator faults (corrupt-agg=/straggle-agg=) but this run has "
                "no aggregation tree — a parameter-server star has no sub-aggregators to fault.  Those keys need "
                "--topology tree:... (the runner then builds its schedule with allow_topology_faults=True)"
                % (offender.start, offender.spec))
        self._starts = np.asarray([r.start for r in regimes], np.int32)
        self._drop_rates = np.asarray([r.drop_rate for r in regimes], np.float32)
        self._straggler_rates = np.asarray([r.straggler_rate for r in regimes], np.float32)
        self._straggler_stale = np.asarray([r.straggler_stale for r in regimes], np.bool_)
        #: the bounded-wait host model's lognormal sigma; the in-step lateness is binary
        self._straggler_jitter = np.asarray([r.straggler_jitter for r in regimes], np.float32)
        self._forge_rates = np.asarray([r.forge_rate for r in regimes], np.float32)
        self._tamper_rates = np.asarray([r.tamper_rate for r in regimes], np.float32)
        self.has_drop = bool((self._drop_rates > 0).any())
        self.has_stragglers = bool((self._straggler_rates > 0).any())
        self.has_forgery = bool((self._forge_rates > 0).any() or (self._tamper_rates > 0).any())
        #: stale stragglers re-send the previous submission: the engine carries it
        self.needs_carry = bool(((self._straggler_rates > 0) & self._straggler_stale).any())
        self.has_local_attacks = any(r.attack is not None and not r.attack.omniscient for r in regimes)
        self.has_omniscient_attacks = any(r.attack is not None and r.attack.omniscient for r in regimes)
        self.has_attacks = self.has_local_attacks or self.has_omniscient_attacks
        self.link = None
        if self.has_drop:
            self.link = LossyLink(self.nb_workers, [
                "drop-rate:0.0",  # each step draws at its regime's rate
                "packet-coords:%d" % int(kv["packet-coords"]),
                "min-coords:%d" % int(kv["min-coords"]),
            ])
        self.stragglers = StragglerModel(self.nb_workers, nb_eligible=int(kv["straggle-workers"]))

    # ------------------------------------------------------------------ #
    # per-step accessors (a host int regime index)

    def regime_at(self, step):
        """The index of the regime governing ``step``: ``max(searchsorted(
        starts, step, side="right") - 1, 0)`` (JAX's traced accessor)."""
        return max(int(np.searchsorted(self._starts, int(step), side="right")) - 1, 0)

    def drop_rate(self, ridx):
        return float(self._drop_rates[ridx])

    def straggler_rate(self, ridx):
        return float(self._straggler_rates[ridx])

    def straggler_stale(self, ridx):
        return bool(self._straggler_stale[ridx])

    def forge_rate(self, ridx):
        return float(self._forge_rates[ridx])

    def tamper_rate(self, ridx):
        return float(self._tamper_rates[ridx])

    def draw_drops(self, d, seed, step, worker, ridx):
        """(nb_packets,) bool CPU tensor: the storm's lost packets of worker
        ``worker``'s (d,) row at ``step``, drawn at regime ``ridx``'s rate
        from the (seed, step, worker, 2) stream."""
        return self.link.draw_drops(d, seed, step, worker, drop_rate=self.drop_rate(ridx))

    def apply_local_attacks(self, ridx, grad, generator):
        """Regime ``ridx``'s local attack on one (d,) row (the identity for a
        regime without one); the caller gates by worker index."""
        attack = self.regimes[ridx].attack
        if attack is None or attack.omniscient:
            return grad
        return attack.apply_local(grad, generator)

    def apply_omniscient_attacks(self, ridx, matrix, byz_mask):
        """Regime ``ridx``'s omniscient attack on the (n, d_block) rows (the
        identity for a regime without one)."""
        attack = self.regimes[ridx].attack
        if attack is None or not attack.omniscient:
            return matrix
        return attack.apply_matrix(matrix, byz_mask)

    # ------------------------------------------------------------------ #
    # host-side helpers (logging, campaign reports)

    def describe(self, index):
        """``start:spec`` of regime ``index``."""
        regime = self.regimes[index]
        return "%d:%s" % (regime.start, regime.spec)

    def transitions(self):
        """[(start_step, spec), ...] of every regime, in order."""
        return [(r.start, r.spec) for r in self.regimes]

    def process_faults(self):
        """[(start_step, kills, hangs), ...] of the regimes carrying
        process-plane faults."""
        return [(r.start, r.kills, r.hangs) for r in self.regimes if r.kills or r.hangs]

    def __len__(self):
        return len(self.regimes)
