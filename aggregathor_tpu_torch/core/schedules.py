"""Learning-rate schedule registry.

Counterpart of ``aggregathor_tpu/core/schedules.py``: ``fixed``,
``polynomial`` and ``exponential``, with the optax formulas (constant,
``polynomial_schedule``, ``exponential_decay``).  A schedule maps the
optimizer's update count, which starts at 0 as optax's does, to a rate.
"""

from .. import config
from ..utils import ClassRegister, parse_keyval

schedules = ClassRegister("learning-rate schedule")


def _fixed(args):
    kv = parse_keyval(args, {"initial-rate": config.default_learning_rate})
    rate = kv["initial-rate"]
    return lambda count: rate


def _polynomial(args):
    kv = parse_keyval(
        args,
        {
            "initial-rate": config.default_learning_rate,
            "end-rate": config.default_end_learning_rate,
            "decay-step": config.default_decay_step,
            "power": 1.0,
        },
    )
    init, end, steps, power = kv["initial-rate"], kv["end-rate"], kv["decay-step"], kv["power"]
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end

    return schedule


def _exponential(args):
    kv = parse_keyval(
        args,
        {
            "initial-rate": config.default_learning_rate,
            "decay-step": config.default_decay_step,
            "decay-rate": config.default_decay_rate,
        },
    )
    init, steps, rate = kv["initial-rate"], kv["decay-step"], kv["decay-rate"]
    if steps <= 0 or rate == 0:
        return lambda count: init
    return lambda count: init if count <= 0 else init * rate ** (count / steps)


schedules.register("fixed", _fixed)
schedules.register("polynomial", _polynomial)
schedules.register("exponential", _exponential)


def build_schedule(name, args=None):
    """Build a schedule (count -> rate) from its registered name and key:value args."""
    return schedules.get(name)(args or [])
