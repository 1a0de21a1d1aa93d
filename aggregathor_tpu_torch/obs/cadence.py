"""Step-delta / wall-period cadence policy.

Counterpart of ``aggregathor_tpu/obs/cadence.py``: a trigger fires when the
step advanced by at least ``delta`` since its last firing, or when
``period`` seconds of wall time passed, whichever criterion is enabled (a
negative value disables it); an enabled trigger also fires at its first
check.  The runner fires each trigger once more at the end of the run.
"""

import time


class CadenceTrigger:
    """Fires on step delta and/or wall period."""

    def __init__(self, delta=-1, period=-1.0):
        self.delta = int(delta)
        self.period = float(period)
        self.last_step = None
        self.last_time = time.monotonic()

    @property
    def enabled(self):
        return self.delta >= 0 or self.period >= 0.0

    def should_fire(self, step):
        if not self.enabled:
            return False
        if self.last_step is None:
            return True  # the first check fires
        if self.delta >= 0 and step - self.last_step >= self.delta:
            return True
        if self.period >= 0.0 and time.monotonic() - self.last_time >= self.period:
            return True
        return False

    def fired(self, step):
        self.last_step = int(step)
        self.last_time = time.monotonic()
