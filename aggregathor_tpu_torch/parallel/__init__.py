"""The flat robust engine on one device (``engine``) and the attacks."""

from . import attacks  # noqa: F401
from .engine import RobustEngine  # noqa: F401
