"""Scalar summary events as JSONL.

Counterpart of ``aggregathor_tpu/obs/summaries.py``: one JSON object a
line, each stamped with the writer's ``run_id`` (given, or made by
``make_run_id``), so the streams of several processes in one directory can
be told apart and joined after the fact.  Non-finite values are written as
``null``: a bare ``NaN`` token is not JSON, and strict readers reject it.
"""

import itertools
import json
import math
import numbers
import os
import time
import uuid

_serial = itertools.count()


def make_run_id():
    """A short unique run id."""
    return uuid.uuid4().hex[:12]


def _finite(value):
    value = float(value)
    return value if math.isfinite(value) else None


def _coerce(value):
    """An integer stays an int (a worker index); a scalar becomes a float,
    or None when not finite; a vector, a list of those."""
    if isinstance(value, numbers.Integral) and not isinstance(value, bool):
        return int(value)
    try:
        return _finite(value)
    except (TypeError, ValueError):
        return [_finite(v) for v in value]


class SummaryWriter:
    """``<directory>/<run_name>-<time>-<pid>-<serial>.jsonl``; with no
    directory every call is a no-op."""

    def __init__(self, directory, run_name="run", run_id=None):
        self.path = None
        self._fd = None
        self.run_id = run_id if run_id is not None else make_run_id()
        if directory:
            os.makedirs(directory, exist_ok=True)
            # the pid tells concurrent processes apart, the serial counter
            # back-to-back runs of one process within one second
            self.path = os.path.join(
                directory, "%s-%d-%d-%d.jsonl" % (run_name, int(time.time()), os.getpid(), next(_serial)))
            self._fd = open(self.path, "x")

    def scalars(self, step, values):
        """One event of scalars or small 1-D vectors."""
        if self._fd is None:
            return
        event = {"wall": time.time(), "step": int(step), "run_id": self.run_id}
        event.update({name: _coerce(value) for name, value in values.items()})
        self._fd.write(json.dumps(event) + "\n")
        self._fd.flush()

    def event(self, step, tag, payload=None):
        """One tagged event line (``{"event": tag, ...}``); the reserved
        ``wall``/``step``/``event``/``run_id`` fields win over payload keys
        of the same name."""
        if self._fd is None:
            return
        record = dict(payload) if payload else {}
        record.update({"wall": time.time(), "step": int(step), "event": str(tag), "run_id": self.run_id})
        self._fd.write(json.dumps(record) + "\n")
        self._fd.flush()

    def close(self):
        if self._fd is not None:
            self._fd.close()
            self._fd = None
