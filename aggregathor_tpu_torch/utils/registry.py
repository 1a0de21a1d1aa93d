"""Universal plugin registry.

The reference wires experiments, aggregators and native ops through one
``ClassRegister`` (reference: tools/misc.py:83-135).  We keep the same three
verbs — ``itemize`` / ``register`` / ``instantiate`` — so every subsystem
(GARs, experiments, attacks, optimizers, schedules) resolves names the same
way from the CLI.
"""

from . import logging as log


class ClassRegister:
    """Name -> class register with uniform error reporting."""

    def __init__(self, singular, plural=None):
        self._singular = singular
        self._plural = plural or (singular + "s")
        self._register = {}

    def itemize(self):
        """List the registered names, sorted."""
        return sorted(self._register.keys())

    def register(self, name, cls):
        """Register ``cls`` under ``name``; warns and overwrites on duplicate."""
        if name in self._register:
            log.warning("%s %r is already registered; overwriting" % (self._singular.capitalize(), name))
        self._register[name] = cls
        return cls

    def get(self, name):
        """Return the registered class, or raise UserException listing the alternatives."""
        if name not in self._register:
            raise log.UserException(
                "Unknown %s %r; available %s: %s"
                % (self._singular, name, self._plural, ", ".join(self.itemize()) or "<none>")
            )
        return self._register[name]

    def instantiate(self, name, *args, **kwargs):
        """Build an instance of the class registered under ``name``."""
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name):
        return name in self._register
