"""The robust engine (``engine``: the flat dataflow over a worker axis and
the sharded one over a (worker, pipe, model) grid), the grid
(``mesh.make_mesh``) and the attacks."""

from . import attacks  # noqa: F401
from .engine import RobustEngine, ShardedRobustEngine  # noqa: F401
from .mesh import make_mesh  # noqa: F401
