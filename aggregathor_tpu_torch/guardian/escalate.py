"""Escalation ladder: what a rollback *changes* so the retry can succeed.

Copy of ``aggregathor_tpu/guardian/escalate.py``, with ``gar=NAME``
validated against this package's registry (``gars.itemize()``): a rung
naming a rule the port does not register refuses with the text of an
unknown rule.

Restoring the last-good snapshot alone only helps against transient faults;
a regime that exceeds the configured rule's breakdown point would
deterministically re-diverge.  Each rollback therefore climbs one rung of a
configurable ladder of defensive overrides.

Grammar (``--guardian-args ladder:RUNG,RUNG,...``)::

  LADDER := RUNG ("," RUNG)*
  RUNG   := "f+K"                      raise the declared Byzantine count by K
          | "gar=NAME[/key:val...]"    swap to GAR NAME (sub-args '/'-separated)
          | "quarantine[=DECAY/THR]"   engage reputation quarantine
          | "lr*X"                     scale the learning rate by X in (0, 1]

Rungs apply CUMULATIVELY: after two rollbacks with the default ladder the
run trains with f+1 AND the median rule.  Overrides are expressed as a
:class:`Overrides` record the runner's training-stack builder consumes;
rungs never mutate live engines -- the runner rebuilds its engine and step
functions from the new record.
"""

from ..utils import UserException

#: the default ladder: cheapest assumption-widening first, then stronger
#: rules (average -> median -> bulyan is the canonical GAR strength order,
#: docs/robustness.md), then active exclusion, then step-size damping
DEFAULT_LADDER = "f+1,gar=median,gar=bulyan,quarantine,lr*0.5"

#: fold_in tag perturbing a restored RNG per rollback attempt — shared by
#: the runner and the campaign harness so the two recovery paths never
#: silently desynchronize their retry streams
RNG_PERTURB_TAG = 0x6A12D1A

#: seed stride for from-scratch retries / input-stream reseeds (prime, so
#: strided seeds never collide with the +1/+2 offsets runs already use)
RESEED_STRIDE = 7919


class Overrides:
    """The training-stack knobs escalation may change, with their originals.

    The runner builds its engine/step functions from one of these; rungs
    produce a modified copy (`apply` never mutates in place, so a failed
    rebuild can fall back to the previous overrides)."""

    __slots__ = ("f", "gar_name", "gar_args", "lr_scale",
                 "reputation_decay", "quarantine_threshold")

    def __init__(self, f, gar_name, gar_args=(), lr_scale=1.0,
                 reputation_decay=None, quarantine_threshold=0.0):
        self.f = int(f)
        self.gar_name = str(gar_name)
        self.gar_args = tuple(gar_args)
        self.lr_scale = float(lr_scale)
        self.reputation_decay = reputation_decay
        self.quarantine_threshold = float(quarantine_threshold)

    def copy(self):
        return Overrides(self.f, self.gar_name, self.gar_args, self.lr_scale,
                         self.reputation_decay, self.quarantine_threshold)

    def describe(self):
        parts = ["f=%d" % self.f, "gar=%s" % self.gar_name]
        if self.gar_args:
            parts.append("gar-args=%s" % "/".join(self.gar_args))
        if self.lr_scale != 1.0:
            parts.append("lr*%g" % self.lr_scale)
        if self.quarantine_threshold:
            parts.append("quarantine=%g/%g"
                         % (self.reputation_decay, self.quarantine_threshold))
        return " ".join(parts)


class _Rung:
    spec = None

    def describe(self):
        return self.spec

    def apply(self, overrides):
        raise NotImplementedError


class RaiseF(_Rung):
    def __init__(self, spec, k):
        self.spec = spec
        self.k = int(k)

    def apply(self, overrides):
        out = overrides.copy()
        out.f = overrides.f + self.k
        return out


class SwapGar(_Rung):
    def __init__(self, spec, name, args):
        self.spec = spec
        self.name = name
        self.args = tuple(args)

    def apply(self, overrides):
        out = overrides.copy()
        out.gar_name = self.name
        out.gar_args = self.args
        return out


class Quarantine(_Rung):
    def __init__(self, spec, decay=0.9, threshold=0.5):
        self.spec = spec
        self.decay = float(decay)
        self.threshold = float(threshold)

    def apply(self, overrides):
        out = overrides.copy()
        if out.reputation_decay is None:
            out.reputation_decay = self.decay
        out.quarantine_threshold = self.threshold
        return out


class ScaleLr(_Rung):
    def __init__(self, spec, factor):
        self.spec = spec
        self.factor = float(factor)

    def apply(self, overrides):
        out = overrides.copy()
        out.lr_scale = overrides.lr_scale * self.factor
        return out


def _parse_rung(spec):
    if spec.startswith("f+"):
        try:
            k = int(spec[2:])
        except ValueError:
            raise UserException("Ladder rung %r: K in 'f+K' is not an integer" % (spec,))
        if k < 1:
            raise UserException("Ladder rung %r: K must be >= 1" % (spec,))
        return RaiseF(spec, k)
    if spec.startswith("gar="):
        from .. import gars as gar_registry

        body = spec[len("gar="):]
        parts = body.split("/")
        name, args = parts[0], parts[1:]
        if name not in gar_registry.itemize():
            raise UserException(
                "Ladder rung %r: unknown GAR %r (registered: %s)"
                % (spec, name, ", ".join(sorted(gar_registry.itemize())))
            )
        for arg in args:
            if ":" not in arg:
                raise UserException(
                    "Ladder rung %r: GAR sub-arg %r is not key:value" % (spec, arg)
                )
        return SwapGar(spec, name, args)
    if spec == "quarantine" or spec.startswith("quarantine="):
        if spec == "quarantine":
            return Quarantine(spec)
        body = spec[len("quarantine="):]
        try:
            decay_text, threshold_text = body.split("/", 1)
            decay, threshold = float(decay_text), float(threshold_text)
        except ValueError:
            raise UserException(
                "Ladder rung %r: expected quarantine=DECAY/THRESHOLD" % (spec,)
            )
        if not 0.0 < decay < 1.0 or not 0.0 < threshold < 1.0:
            raise UserException(
                "Ladder rung %r: decay and threshold must lie in (0, 1)" % (spec,)
            )
        return Quarantine(spec, decay, threshold)
    if spec.startswith("lr*"):
        try:
            factor = float(spec[3:])
        except ValueError:
            raise UserException("Ladder rung %r: X in 'lr*X' is not a number" % (spec,))
        if not 0.0 < factor <= 1.0:
            raise UserException("Ladder rung %r: X must lie in (0, 1]" % (spec,))
        return ScaleLr(spec, factor)
    raise UserException(
        "Unknown ladder rung %r (expected f+K, gar=NAME[/key:val...], "
        "quarantine[=DECAY/THR], or lr*X)" % (spec,)
    )


def note_escalation(step, rung, overrides):
    """Journal one APPLIED escalation rung (obs/events.py): called by the
    runner's rollback path after the rebuilt training stack is live, so the
    event records what the run actually trains with from ``step`` on — a
    rejected rung (infeasible under the new f, unmaskable GAR) never
    journals.  Pure side-channel: no engine state is touched here."""
    from ..obs import events

    events.emit("guardian_escalation", step=step, rung=rung.describe(),
                overrides=overrides.describe())


class EscalationLadder:
    """Parsed ladder: ``rung(i)`` is the override to stack on attempt i+1
    (None past the end — later retries keep the last escalated config and
    rely on the rollback's RNG perturbation alone)."""

    def __init__(self, spec=DEFAULT_LADDER):
        self.spec = str(spec)
        specs = [s for s in self.spec.split(",") if s]
        if not specs:
            raise UserException("Empty escalation ladder (expected e.g. %r)" % DEFAULT_LADDER)
        self.rungs = [_parse_rung(s) for s in specs]

    def rung(self, index):
        return self.rungs[index] if 0 <= index < len(self.rungs) else None

    def __len__(self):
        return len(self.rungs)

    def describe(self):
        return ",".join(r.describe() for r in self.rungs)
