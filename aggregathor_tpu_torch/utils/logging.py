"""Nested-context colored logging.

Re-implements the observable behaviour of the reference's ``tools.Context``
stack (reference: tools/__init__.py:52-227): log lines are prefixed with the
chain of active ``[context]`` headers for the current thread, severity
shortcuts colorize output when attached to a TTY, and ``fatal`` raises a
``UserException`` that the CLI converts into a clean ``exit(1)`` instead of a
traceback (reference: tools/__init__.py:232-258).

The implementation is deliberately simpler than the reference's stdout/stderr
stream wrapping: we format explicit log calls only, which keeps worker
processes (multi-host JAX) from fighting over a monkey-patched sys.stdout.
"""

import os
import sys
import threading

_LOCAL = threading.local()

_COLORS = {
    "trace": "\033[90m",
    "info": "\033[0m",
    "success": "\033[32m",
    "warning": "\033[33m",
    "error": "\033[31m",
    "fatal": "\033[1;31m",
}
_RESET = "\033[0m"


class UserException(RuntimeError):
    """Error caused by the user; reported without a traceback (reference: tools/__init__.py:232-244)."""


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Context:
    """Context manager pushing a ``[name]`` header onto the current thread's log prefix."""

    def __init__(self, name):
        self.name = str(name)

    def __enter__(self):
        _stack().append(self.name)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def _use_color(stream):
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(stream, "isatty") and stream.isatty()


def _emit(level, *args, stream=None):
    stream = stream if stream is not None else (sys.stderr if level in ("warning", "error", "fatal") else sys.stdout)
    prefix = "".join("[%s] " % name for name in _stack())
    thread = threading.current_thread()
    if thread is not threading.main_thread():
        prefix = "[%s] %s" % (thread.name, prefix)
    text = " ".join(str(a) for a in args)
    if _use_color(stream):
        stream.write("%s%s%s%s\n" % (_COLORS[level], prefix, text, _RESET))
    else:
        stream.write("%s%s\n" % (prefix, text))
    stream.flush()


def trace(*args):
    _emit("trace", *args)


def info(*args):
    _emit("info", *args)


def success(*args):
    _emit("success", *args)


def warning(*args):
    _emit("warning", "[warning]", *args)


def error(*args):
    _emit("error", "[error]", *args)


def fatal(*args):
    """Log at fatal severity and raise UserException (clean exit path)."""
    _emit("fatal", "[fatal]", *args)
    raise UserException(" ".join(str(a) for a in args))


class _Tee:
    """Write-through to a primary stream plus a log file (reference: tools/misc.py:45-78).

    Everything not overridden (fileno, buffer, encoding, ...) delegates to the
    primary stream, so low-level consumers (subprocess, faulthandler, C-level
    logging) keep working; only the text-mode ``write`` path is duplicated
    into the file.
    """

    def __init__(self, primary, path):
        self._primary = primary
        self._file = open(path, "a")

    def write(self, text):
        count = self._primary.write(text)
        self._file.write(text)
        self._file.flush()
        return count

    def flush(self):
        self._primary.flush()
        self._file.flush()

    def isatty(self):
        return False

    def __getattr__(self, name):
        return getattr(self._primary, name)


def replicate_streams(stdout_path=None, stderr_path=None):
    """Tee stdout/stderr into files (the reference's ``--stdout-to/--stderr-to``)."""
    if stdout_path:
        sys.stdout = _Tee(sys.stdout, stdout_path)
    if stderr_path:
        sys.stderr = _Tee(sys.stderr, stderr_path)
