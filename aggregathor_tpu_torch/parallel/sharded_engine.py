"""The sharded engine under its historical name: an alias of
``RobustEngine(sharding="sharded")`` (counterpart of JAX
``parallel/sharded_engine.py``)."""

from .engine import RobustEngine, ShardedRobustEngine  # noqa: F401
