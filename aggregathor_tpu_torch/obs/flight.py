"""Flight recorder: a fixed-size ring of per-step telemetry written in the step.

Counterpart of ``aggregathor_tpu/obs/flight.py``.  The ring is a dict of
device tensors carried as ``TrainState.flight`` (never saved); the engine
writes step s's row into slot ``s % C`` in place, with no host read, so
every step of an ``--unroll`` chunk leaves a row.  The host fetches the
whole ring once a summary fire and dumps it post-mortem when a run
diverges or crashes.

Lanes, each present only when the engine computes its source:

====================  ========  =========================================
lane                  shape     source
====================  ========  =========================================
``step``              (C,)      the step's index (slot validity tag, -1)
``loss``              (C,)      ``metrics["total_loss"]``
``update_norm``       (C,)      ``metrics["grad_norm"]``
``spike``             (C,)      the probe's spike score
``loss_finite``       (C,)      the probe's finite-loss flag
``worker_nan``        (C, n)    the probe's NaN-row flags
``worker_sq_dist``    (C, n)    per-worker squared distance (worker metrics)
``chaos_regime``      (C,)      the step's chaos regime index (``--chaos``)
``secure_rejected``   (C, n)    the rejected submissions (``--secure``)
====================  ========  =========================================

Each lane stores the value the metrics dict carries, so a fetched row is
bit-identical to that step's metrics.

The post-mortem document has schema ``aggregathor.obs.flight.v1``
(``dump_window``); non-finite floats are the strings ``"nan"``, ``"inf"``
and ``"-inf"``.
"""

import json
import os
import time

import numpy as np
import torch

from ..guardian.probe import PROBE_KEY
from ..utils import UserException

SCHEMA = "aggregathor.obs.flight.v1"

#: lanes shaped (C,): name -> (dtype, fill value)
_SCALAR_LANES = {
    "step": (torch.int32, -1),
    "loss": (torch.float32, float("nan")),
    "update_norm": (torch.float32, float("nan")),
}
_PROBE_SCALAR_LANES = {
    "spike": (torch.float32, float("nan")),
    "loss_finite": (torch.int32, -1),
}


class FlightRecorder:
    """The ring's layout (capacity and lanes), its in-step write and its
    host fetch.

    Args:
      capacity: ring rows (>= 1); size it to at least the summary cadence
        (and ``--unroll``) to fetch every step once.
      nb_workers: n, the width of the per-worker lanes.
      probe: record the probe lanes (needs the engine's ``health_probe``).
      worker_metrics: record ``worker_sq_dist`` (needs ``worker_metrics``).
      chaos: record the regime-index lane; needs a chaos schedule.
      secure: record the rejected-submission lane; needs secure submission.
    """

    def __init__(self, capacity, nb_workers, probe=True, worker_metrics=False, chaos=False, secure=False):
        self.capacity = int(capacity)
        self.nb_workers = int(nb_workers)
        if self.capacity < 1:
            raise UserException("FlightRecorder wants capacity >= 1 (got %d)" % self.capacity)
        if self.nb_workers < 1:
            raise UserException("FlightRecorder wants nb_workers >= 1 (got %d)" % self.nb_workers)
        self.probe = bool(probe)
        self.worker_metrics = bool(worker_metrics)
        self.chaos = bool(chaos)
        self.secure = bool(secure)

    # ------------------------------------------------------------------ #
    # engine side

    def validate_for(self, nb_workers, probe, worker_metrics, chaos=False, secure=False):
        """Fail loudly when a lane's source metric is absent from the engine."""
        if nb_workers != self.nb_workers:
            raise UserException(
                "FlightRecorder was sized for n=%d workers but the engine has %d" % (self.nb_workers, nb_workers)
            )
        for lane, wanted, have in (
            ("probe", self.probe, probe),
            ("worker_sq_dist", self.worker_metrics, worker_metrics),
            ("chaos_regime", self.chaos, chaos),
            ("secure_rejected", self.secure, secure),
        ):
            if wanted and not have:
                raise UserException(
                    "FlightRecorder records the %r lane but the engine does not compute its source metric" % lane
                )

    def lane_shapes(self):
        """{name: (shape, dtype, fill)} of every configured lane."""
        C, n = self.capacity, self.nb_workers
        lanes = {name: ((C,), dtype, fill) for name, (dtype, fill) in _SCALAR_LANES.items()}
        if self.probe:
            lanes.update({name: ((C,), dtype, fill) for name, (dtype, fill) in _PROBE_SCALAR_LANES.items()})
            lanes["worker_nan"] = ((C, n), torch.int32, -1)
        if self.worker_metrics:
            lanes["worker_sq_dist"] = ((C, n), torch.float32, float("nan"))
        if self.chaos:
            lanes["chaos_regime"] = ((C,), torch.int32, -1)
        if self.secure:
            lanes["secure_rejected"] = ((C, n), torch.int32, -1)
        return lanes

    def init_buffers(self, device="cpu"):
        """A fresh ring on ``device``, every slot empty."""
        return {name: torch.full(shape, fill, dtype=dtype, device=device)
                for name, (shape, dtype, fill) in self.lane_shapes().items()}

    def record(self, buffers, step, metrics):
        """Write step ``step``'s row into slot ``step % C`` of ``buffers``,
        in place, from the values ``metrics`` carries; returns ``buffers``."""
        slot = int(step) % self.capacity

        def put(name, value):
            buffers[name][slot].copy_(value)

        buffers["step"][slot] = int(step)
        put("loss", metrics["total_loss"])
        put("update_norm", metrics["grad_norm"])
        if self.probe:
            probe = metrics[PROBE_KEY]
            put("spike", probe["spike"])
            put("loss_finite", probe["loss_finite"])
            put("worker_nan", probe["worker_nan_rows"])
        if self.worker_metrics:
            put("worker_sq_dist", metrics["worker_sq_dist"])
        if self.chaos:
            put("chaos_regime", metrics["chaos_regime"])
        if self.secure:
            put("secure_rejected", metrics["secure"]["rejected"])
        return buffers

    # ------------------------------------------------------------------ #
    # host side

    def fetch(self, buffers):
        """The ring -> its valid window on the host, ordered by step:
        ``{lane: np.ndarray}``, slots never written (step -1) dropped.  The
        ``step`` lane holds step indices: row s is the step that took the
        count from s to s + 1."""
        host = {name: value.detach().cpu().numpy() for name, value in buffers.items()}
        steps = host["step"]
        order = np.argsort(steps, kind="stable")
        order = order[steps[order] >= 0]
        return {name: value[order] for name, value in host.items()}


def summarize_window(window, tail=5):
    """A small JSON-able view of a fetched window: the step range, the row
    count and the last ``tail`` rows of the scalar lanes."""
    steps = window.get("step")
    if steps is None or steps.size == 0:
        return {"rows": 0}
    out = {"rows": int(steps.size), "first_step": int(steps[0]), "last_step": int(steps[-1])}
    for lane in ("loss", "update_norm", "spike", "chaos_regime"):
        if lane in window:
            out[lane] = [_json_value(v) for v in window[lane][-int(tail):]]
    if "worker_nan" in window:
        out["worker_nan_rows_last"] = [int(v) for v in np.asarray(window["worker_nan"][-1]).reshape(-1)]
    return out


def _json_value(value):
    """A strict-JSON scalar: a non-finite float becomes a tagged string (a
    post-mortem keeps NaN apart from +-inf)."""
    if isinstance(value, (np.integer, int)):
        return int(value)
    value = float(value)
    if np.isfinite(value):
        return value
    if np.isnan(value):
        return "nan"
    return "inf" if value > 0 else "-inf"


def dump_window(path, window, run_id=None, reason=None, capacity=None, extra=None):
    """Write a fetched window as a post-mortem document (schema ``SCHEMA``;
    a temporary file, then a rename).  Returns the document."""
    lanes = {}
    for name, values in window.items():
        arr = np.asarray(values)
        if arr.ndim <= 1:
            lanes[name] = [_json_value(v) for v in arr]
        else:
            lanes[name] = [[_json_value(v) for v in row] for row in arr]
    steps = window.get("step")
    doc = {
        "schema": SCHEMA,
        "run_id": run_id,
        "reason": reason,
        "written_at": time.time(),
        "capacity": capacity,
        "rows": int(steps.size) if steps is not None else 0,
        "step_range": [int(steps[0]), int(steps[-1])] if steps is not None and steps.size else None,
        "lanes": lanes,
    }
    if extra:
        doc["extra"] = dict(extra)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fd:
        json.dump(doc, fd, indent=1)
        fd.write("\n")
    os.replace(tmp, path)
    return doc


def load_window(path):
    """Load and schema-check a post-mortem document."""
    with open(path) as fd:
        doc = json.load(fd)
    if doc.get("schema") != SCHEMA:
        raise ValueError("expected schema %r, got %r" % (SCHEMA, doc.get("schema")))
    if not isinstance(doc.get("lanes"), dict) or "step" not in doc["lanes"]:
        raise ValueError("flight document wants a lanes dict with a step lane")
    nb = len(doc["lanes"]["step"])
    for name, rows in doc["lanes"].items():
        if len(rows) != nb:
            raise ValueError("lane %r has %d rows, step lane has %d" % (name, len(rows), nb))
    return doc
