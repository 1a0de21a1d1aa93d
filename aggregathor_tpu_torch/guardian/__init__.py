"""guardian/ -- in-loop divergence watchdog and rollback-and-escalate recovery.

Counterpart of ``aggregathor_tpu/guardian``.  The aggregation rules in
``gars/`` defend each step; the guardian defends the run:

1. **Health probe** (``probe.py``) -- finite-loss flag, aggregated-update
   norm, EMA loss-spike score and per-worker NaN-row flags, computed in the
   engine's step and returned with the step metrics (``metrics["probe"]``);
2. **Watchdog and escalation** (``watchdog.py``, ``escalate.py``) -- a
   host-side policy that, on sustained divergence, has the runner restore
   the last-known-good snapshot (``obs/checkpoint.py`` pin), perturb the
   restored random streams, and climb a configurable escalation ladder
   (raise ``f`` -> stronger GAR -> quarantine -> damp the lr) with bounded
   retries and exponential backoff (the runner's ``--guardian``).
"""

from .escalate import (  # noqa: F401
    DEFAULT_LADDER,
    RESEED_STRIDE,
    RNG_PERTURB_TAG,
    EscalationLadder,
    Overrides,
    note_escalation,
)
from .probe import (  # noqa: F401
    EMA_DECAY,
    EMA_UNSET,
    PROBE_KEY,
    host_view,
    probe_metrics,
    spike_score,
    update_loss_ema,
)
from .watchdog import GuardianConfig, Watchdog  # noqa: F401
