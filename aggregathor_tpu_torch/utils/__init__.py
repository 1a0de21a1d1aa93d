"""Shared utilities: context logging, class registry, key:value parsing,
plugin import, filesystem access checks, devices, derived seeds.

Copies of the framework-free helpers of ``aggregathor_tpu.utils`` (the port
keeps its own copies and imports nothing of the JAX package), plus
``resolve_device``: the one place that turns a ``--device``/``device=``
request into a ``torch.device``.
"""

from .logging import (  # noqa: F401
    Context,
    UserException,
    trace,
    info,
    success,
    warning,
    error,
    fatal,
    replicate_streams,
)
from .registry import ClassRegister  # noqa: F401
from .keyval import parse_keyval  # noqa: F401
from .device import resolve_device  # noqa: F401
from .plugins import import_directory  # noqa: F401
from .access import can_access  # noqa: F401
from .seeds import fold_in_seed  # noqa: F401
