"""Fleet supervisor: the control loop over the journal, the fleet scrape
and the sentinel's verdicts.

Counterpart of ``aggregathor_tpu/supervisor`` (it imports no JAX).  The
journal, the fleet scrape and the round timelines make every steering
decision observable, and the sentinel (``obs/slo.py``) judges runs after
the fact; the supervisor acts on those signals live, one rung above the
guardian, with the guardian's separation:

- :mod:`policy` — a PURE decision layer (``SupervisorPolicy``): fleet
  snapshot + journal tail + sentinel verdicts in, typed actions out.
  No I/O, no wall clock, fully exercised on a synthetic clock.
- :mod:`actuator` — ``FleetSupervisor``: spawns the fleet, scrapes it,
  tails its journals, feeds the policy and EXECUTES its actions
  (restart / quarantine / retune / rollback), journaling every one with
  its triggering evidence (``supervisor_*`` event types, obs/events.py).

``cli.supervise`` is the operator's face and ``cli.postmortem`` replays
the journals it leaves.
"""

from .policy import (  # noqa: F401
    Observe,
    Quarantine,
    Restart,
    Retune,
    Rollback,
    SupervisorConfig,
    SupervisorPolicy,
)
from .actuator import FleetSupervisor, InstanceSpec  # noqa: F401
