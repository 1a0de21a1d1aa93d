"""Training core: flatten machinery, schedules, optimizers, train state.

Counterpart of ``aggregathor_tpu/core``: the flat gradient vector keeps the
JAX package's coordinate order, and the optimizers and schedules follow the
optax formulas, not ``torch.optim``'s.
"""

from .flatten import FlatMap  # noqa: F401
from .schedules import schedules, build_schedule  # noqa: F401
from .optimizers import optimizers, build_optimizer  # noqa: F401
from .train_state import TrainState, host_snapshot, load_snapshot  # noqa: F401
