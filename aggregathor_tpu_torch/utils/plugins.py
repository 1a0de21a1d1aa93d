"""Directory-based plugin auto-import.

Copy of ``aggregathor_tpu/utils/plugins.py``.  The reference
auto-imports every ``.py`` file in ``aggregators/`` and ``experiments/``
so plugins self-register at import time (reference:
tools/__init__.py:263-318).  Here plugins are regular modules inside a
package; ``import_directory`` imports every sibling module of the calling
package so drop-in files self-register the same way.
"""

import importlib
import pkgutil

from . import logging as log


def import_directory(package_name, package_path, skip=()):
    """Import every module in a package directory (plugins self-register on import).

    Args:
      package_name: the package's ``__name__``.
      package_path: the package's ``__path__``.
      skip:         module basenames to skip.
    Returns:
      list of imported module objects.
    """
    imported = []
    for modinfo in pkgutil.iter_modules(package_path):
        if modinfo.name.startswith("_") or modinfo.name in skip:
            continue
        try:
            imported.append(importlib.import_module(package_name + "." + modinfo.name))
        except log.UserException:
            raise
        except Exception as err:  # plugin failure must not take down the framework
            log.warning("Plugin module %r failed to import and was skipped: %s" % (modinfo.name, err))
    return imported
