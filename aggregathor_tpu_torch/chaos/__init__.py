"""Chaos engineering for Byzantine-resilient training.

Counterpart of ``aggregathor_tpu/chaos/``: adversity as a schedule rather
than whole-run knobs.

- ``schedule``: the piecewise fault-regime DSL (``0:calm 500:drop=0.3
  1000:attack=empire``), indexed by the step;
- ``stragglers``: late workers, whose rows drop out (NaN) or go stale (the
  previous submission, the engine's CLEVER carry);
- ``campaign``: the resilience campaign, attack x GAR x schedule grids
  through the real engine, a JSON matrix and a markdown report;
- ``replica_faults``: the serving path's replica parameter faults.

``RobustEngine(..., chaos=...)`` consumes a ``ChaosSchedule``; the runner
spells it ``--chaos "<schedule>" --chaos-args key:value...``.
"""

from .schedule import ChaosSchedule  # noqa: F401
from .stragglers import StragglerModel  # noqa: F401
from .replica_faults import (  # noqa: F401
    PARAM_FAULTS,
    REPLICA_FAULTS,
    corrupt_params,
    parse_poison,
)
