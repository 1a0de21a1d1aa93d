"""The train state: one canonical copy of the parameters and its optimizer state.

Counterpart of ``aggregathor_tpu/core/train_state.py`` for the main path:
the side buffers of the JAX state (CLEVER carry, worker momentum,
reputation, flight ring, error feedback) belong to features this package
does not port yet.
"""

import dataclasses


@dataclasses.dataclass
class TrainState:
    """Parameters (name -> tensor, torch layout), optimizer state, the number
    of completed steps and the run's seed (the per-step random streams are
    derived from ``(seed, step, worker, tag)``)."""

    params: dict
    opt_state: dict
    step: int = 0
    seed: int = 0
