"""Typed ``key:value`` sub-argument parsing.

The reference passes plugin-specific options as lists of ``key:value`` strings
(e.g. ``--learning-rate-args initial-rate:0.05``) parsed against typed
defaults (reference: tools/misc.py:140-170).  Same contract here: the value
string is coerced to the type of the default when one is supplied; without a
default the value is auto-coerced (int, then float, then bool-ish, then str).
"""

from . import logging as log


def _auto(value):
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    low = value.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    return value


def _coerce(value, default):
    if isinstance(default, bool):
        return _auto(value) in (True, 1)
    return type(default)(value)


def parse_keyval(pairs, defaults=None, strict=False):
    """Parse a list of ``"key:value"`` strings into a dict.

    Args:
      pairs:    iterable of ``key:value`` strings (value may contain ':').
      defaults: optional dict of typed defaults; parsed values are coerced to
                the default's type, and missing keys take the default value.
      strict:   reject keys not present in ``defaults`` (catches typo'd or
                unsupported options instead of silently ignoring them).
    Returns:
      dict of key -> typed value.
    """
    result = dict(defaults) if defaults else {}
    seen = set()
    for pair in pairs or []:
        if ":" not in pair:
            raise log.UserException("Expected 'key:value' argument, got %r" % (pair,))
        key, value = pair.split(":", 1)
        if key in seen:
            raise log.UserException("Key %r had already been specified" % (key,))
        seen.add(key)
        if strict and key not in (defaults or {}):
            raise log.UserException(
                "Unknown key %r (accepted: %s)"
                % (key, ", ".join(sorted(defaults)) if defaults else "none")
            )
        if defaults is not None and key in defaults and defaults[key] is not None:
            try:
                result[key] = _coerce(value, defaults[key])
            except (TypeError, ValueError):
                raise log.UserException(
                    "Invalid value %r for key %r (expected %s)" % (value, key, type(defaults[key]).__name__)
                )
        else:
            result[key] = _auto(value)
    return result
