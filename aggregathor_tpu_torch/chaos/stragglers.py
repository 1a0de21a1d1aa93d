"""Per-worker straggler simulation: a late worker's row drops out or goes stale.

Counterpart of ``aggregathor_tpu/chaos/stragglers.py``.  A late worker's
slot becomes either

- **drop**: a whole row of NaN, the lossy link's convention: the NaN-aware
  rules exclude it, plain ``average`` is poisoned;
- **stale**: the worker's previous submission, kept in the engine's
  ``TrainState.carry`` (the CLEVER carry): a worker late k steps in a row
  re-sends the same row k times; at rate 1.0 this is a clever lossy link
  at drop-rate 1.0, bit for bit.

Lateness is one Bernoulli draw per (step, worker) at the regime's rate.
The draw and the replacement are two functions, as the lossy link's are:
``draw_late`` reads the (seed, step, worker, 5) stream on a CPU generator,
so a run is late at the same places on the card and on the CPU, whatever
W; ``apply`` replaces a row given any verdict (the tests inject the JAX
package's threefry draws, which a torch generator cannot reproduce).
``straggle-workers:K`` restricts lateness to the workers w < K.
"""

import torch

from ..utils import UserException

#: stream tag of the lateness draw, as the JAX engine folds it (attack 1,
#: lossy 2, augment 3, sampling 4)
STRAGGLER_KEY_TAG = 5


class StragglerModel:
    """Static straggler config; the per-step rate and mode come from the schedule."""

    def __init__(self, nb_workers, nb_eligible=0):
        self.nb_workers = int(nb_workers)
        # 0: every worker is eligible; K > 0: only the first K global workers
        self.nb_eligible = int(nb_eligible)
        if self.nb_eligible < 0 or self.nb_eligible > self.nb_workers:
            raise UserException("straggle-workers must lie in [0, nb_workers]=%d (got %d)"
                                % (self.nb_workers, self.nb_eligible))

    def draw_late(self, seed, step, worker, rate, tag=STRAGGLER_KEY_TAG):
        """bool: is worker ``worker`` late at ``step``?  One draw of the
        (seed, step, worker, 5) stream on a CPU generator (``torch.rand <
        rate``: never at rate 0, always at rate 1), gated by
        ``straggle-workers``."""
        from ..parallel.engine import stream_generator

        if self.nb_eligible and worker >= self.nb_eligible:
            return False
        generator = stream_generator(seed, step, worker, tag, torch.device("cpu"))
        return bool(torch.rand((), generator=generator) < rate)

    def apply(self, grad, late, stale, previous=None):
        """Worker's (d,) row, or its regime's infill when ``late``: the
        ``previous`` submission when ``stale`` (and the carry exists), else
        a NaN row."""
        if not late:
            return grad
        if stale and previous is not None:
            return previous.clone()
        return torch.full_like(grad, float("nan"))
