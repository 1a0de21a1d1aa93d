"""The train state: one canonical copy of the parameters and its optimizer state.

Counterpart of ``aggregathor_tpu/core/train_state.py`` for the main path
and the lossy link's CLEVER carry; the other side buffers of the JAX state
(worker momentum, reputation, flight ring, error feedback) belong to
features this package does not port yet.
"""

import dataclasses


@dataclasses.dataclass
class TrainState:
    """Parameters (name -> tensor, torch layout), optimizer state, the number
    of completed steps, the run's seed (the per-step random streams are
    derived from ``(seed, step, worker, tag)``) and ``carry``: the (n, d) rows
    received last step, which a packet lost under ``clever:true`` keeps (None
    unless the engine carries them)."""

    params: dict
    opt_state: dict
    step: int = 0
    seed: int = 0
    carry: object = None
