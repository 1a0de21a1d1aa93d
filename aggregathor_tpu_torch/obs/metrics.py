"""Process-wide metrics registry with Prometheus text exposition.

A copy of ``aggregathor_tpu/obs/metrics.py`` (the module imports no JAX):
counters, gauges and histograms registered by name (get-or-create, so every
subsystem reaches the same instrument), readable as a JSON-able snapshot and
as Prometheus text exposition (format 0.0.4).  The runner dumps the
exposition through ``--metrics-file`` and serves it live on ``/metrics``
(``obs/live.py``); the input pipeline, the perf report and the GAR probe
report to it.

- :class:`Counter`    monotonically increasing float (``inc``)
- :class:`Gauge`      settable float, or a scrape-time callback
  (``set_function``: queue depths are read live)
- :class:`Histogram`  bucketed counts + sum for Prometheus, backed by
  ``obs.perf.LatencyHistogram`` as the reservoir for p50/p95/p99 readout;
  ``record``/``percentiles``/``count`` keep the LatencyHistogram API.

Labels: a metric created with ``labelnames`` is a *family*; ``.labels(v1,
...)`` (or keyword form) returns the per-labelset child, created on demand.
Exposition escapes label values per the Prometheus text format (backslash,
double quote, newline).

Everything is thread-safe; ``REGISTRY`` is the process-wide default.
:func:`parse_prometheus` is a minimal strict text-format parser used by the
tests and ``chip_smoke.py`` to round-trip the exposition.  The text and the
snapshot are those of the JAX package for the same operations.
"""

import bisect
import re
import threading

from ..utils import UserException

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds — latency-shaped, like prometheus_client)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt(value):
    """Prometheus sample-value formatting: +Inf/-Inf/NaN spelled out."""
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(float(value))


def escape_label_value(value):
    r"""Escape a label value for the text format: ``\`` ``"`` and newline."""
    return (
        str(value).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _escape_help(text):
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


# --------------------------------------------------------------------- #
# children (one per labelset)


class Counter:
    """Monotonically increasing value.  ``inc`` only; decreasing raises."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        amount = float(amount)
        if amount < 0.0:
            raise UserException("Counter can only increase (inc %g)" % amount)
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Settable value, or a scrape-time callback (``set_function``)."""

    def __init__(self):
        self._value = 0.0
        self._fn = None
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += float(amount)

    def dec(self, amount=1.0):
        self.inc(-amount)

    def set_function(self, fn):
        """Read ``fn()`` at scrape time instead of a stored value — live
        views (queue depth, compile count) without a writer loop."""
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        return float(fn())


class Histogram:
    """Cumulative-bucket histogram + reservoir percentiles.

    The Prometheus side is the classic fixed-bucket form (le-bucket counts,
    ``_sum``, ``_count``); the reservoir side reuses
    ``obs.perf.LatencyHistogram`` so ``percentiles()`` reports the same
    p50/p95/p99 the perf report prints.
    ``record`` aliases ``observe`` for LatencyHistogram API compatibility.
    """

    def __init__(self, buckets=None, reservoir=None):
        from .perf import LatencyHistogram

        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bounds:
            raise UserException("Histogram wants at least one bucket bound")
        self.bounds = bounds
        self.reservoir = reservoir if reservoir is not None else LatencyHistogram()
        self._counts = [0] * (len(bounds) + 1)  # last slot: +Inf
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        self.reservoir.record(value)
        slot = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[slot] += 1
            self._sum += value

    record = observe  # LatencyHistogram-compatible

    def percentiles(self):
        return self.reservoir.percentiles()

    @property
    def count(self):
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def cumulative_buckets(self):
        """[(le_bound, cumulative_count)] ending with (+Inf, total)."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, count in zip(self.bounds + (float("inf"),), counts):
            running += count
            out.append((bound, running))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# --------------------------------------------------------------------- #
# families


class MetricFamily:
    """One named metric + its per-labelset children.  With no
    ``labelnames`` the family IS its single child: ``inc``/``set``/
    ``observe``/... delegate straight through."""

    def __init__(self, name, kind, help="", labelnames=(), **kwargs):
        if not _METRIC_NAME.match(name):
            raise UserException("Invalid metric name %r" % name)
        for label in labelnames:
            if not _LABEL_NAME.match(label):
                raise UserException("Invalid label name %r (metric %r)" % (label, name))
        if kind not in _KINDS:
            raise UserException("Unknown metric kind %r" % kind)
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._children = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _KINDS[kind](**kwargs)

    def labels(self, *values, **kv):
        """The child for one labelset (created on demand).  Positional
        values follow ``labelnames`` order; keyword form also accepted."""
        if kv:
            if values:
                raise UserException("labels() wants positional OR keyword values")
            try:
                values = tuple(kv.pop(name) for name in self.labelnames)
            except KeyError as exc:
                raise UserException("Missing label %s for metric %r" % (exc, self.name))
            if kv:
                raise UserException(
                    "Unknown label(s) %s for metric %r" % (sorted(kv), self.name)
                )
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise UserException(
                "Metric %r wants %d label(s) %r, got %r"
                % (self.name, len(self.labelnames), self.labelnames, values)
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = _KINDS[self.kind](**self._kwargs)
            return child

    def children(self):
        with self._lock:
            return dict(self._children)

    # label-less convenience: the family acts as its single child
    def _solo(self):
        if self.labelnames:
            raise UserException(
                "Metric %r has labels %r; call .labels(...) first"
                % (self.name, self.labelnames)
            )
        return self._children[()]

    def inc(self, amount=1.0):
        return self._solo().inc(amount)

    def dec(self, amount=1.0):
        return self._solo().dec(amount)

    def set(self, value):
        return self._solo().set(value)

    def set_function(self, fn):
        return self._solo().set_function(fn)

    def observe(self, value):
        return self._solo().observe(value)

    record = observe

    def percentiles(self):
        return self._solo().percentiles()

    def cumulative_buckets(self):
        return self._solo().cumulative_buckets()

    @property
    def value(self):
        return self._solo().value

    @property
    def count(self):
        return self._solo().count

    @property
    def sum(self):
        return self._solo().sum


# --------------------------------------------------------------------- #
# registry


class MetricsRegistry:
    """Named metric families, get-or-create.  Re-requesting a name returns
    the existing family (so independent subsystems share instruments); a
    kind or labelnames mismatch fails loudly instead of silently forking
    the metric."""

    def __init__(self):
        self._families = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name, kind, help, labelnames, **kwargs):
        with self._lock:
            family = self._families.get(name)
            if family is not None:
                if family.kind != kind or family.labelnames != tuple(labelnames):
                    raise UserException(
                        "Metric %r already registered as %s%r; cannot re-register "
                        "as %s%r" % (name, family.kind, family.labelnames,
                                     kind, tuple(labelnames))
                    )
                if kind == "histogram":
                    # a bucket mismatch must fail loudly too — returning the
                    # first registrant's bounds would silently misfile the
                    # second caller's observations
                    have = family._kwargs.get("buckets")
                    want = kwargs.get("buckets")
                    if have != want:
                        raise UserException(
                            "Histogram %r already registered with buckets %r; "
                            "cannot re-register with %r" % (name, have, want)
                        )
                return family
            family = MetricFamily(name, kind, help=help, labelnames=labelnames, **kwargs)
            self._families[name] = family
            return family

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(name, "counter", help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(name, "gauge", help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None, reservoir=None):
        # normalized up front so the mismatch check compares what Histogram
        # will actually use, not the caller's spelling
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        return self._get_or_create(
            name, "histogram", help, labelnames, buckets=bounds, reservoir=reservoir
        )

    def families(self):
        with self._lock:
            return [self._families[name] for name in sorted(self._families)]

    def unregister(self, name):
        """Drop a family (tests, a closed live exporter)."""
        with self._lock:
            self._families.pop(name, None)

    # ------------------------------------------------------------------ #
    # readout

    def snapshot(self):
        """JSON-able view: name -> value (label-less) or
        ``{labelset_repr: value}``; histograms -> {count, sum, percentiles}."""
        out = {}
        for family in self.families():
            def one(child):
                if family.kind == "histogram":
                    return {
                        "count": child.count,
                        "sum": child.sum,
                        "percentiles": child.percentiles(),
                    }
                return child.value
            children = family.children()
            if not family.labelnames:
                out[family.name] = one(children[()])
            else:
                out[family.name] = {
                    ",".join("%s=%s" % kv for kv in zip(family.labelnames, values)):
                        one(child)
                    for values, child in sorted(children.items())
                }
        return out

    def render_prometheus(self):
        """Prometheus text exposition (format 0.0.4) of every family."""
        lines = []
        for family in self.families():
            lines.append("# HELP %s %s" % (family.name, _escape_help(family.help)))
            lines.append("# TYPE %s %s" % (family.name, family.kind))
            for values, child in sorted(family.children().items()):
                base_labels = list(zip(family.labelnames, values))

                def render_labels(extra=()):
                    pairs = base_labels + list(extra)
                    if not pairs:
                        return ""
                    return "{%s}" % ",".join(
                        '%s="%s"' % (k, escape_label_value(v)) for k, v in pairs
                    )

                if family.kind == "histogram":
                    for bound, cumulative in child.cumulative_buckets():
                        lines.append("%s_bucket%s %s" % (
                            family.name, render_labels([("le", _fmt(bound))]),
                            _fmt(cumulative),
                        ))
                    lines.append("%s_sum%s %s" % (
                        family.name, render_labels(), _fmt(child.sum)))
                    lines.append("%s_count%s %s" % (
                        family.name, render_labels(), _fmt(child.count)))
                else:
                    lines.append("%s%s %s" % (
                        family.name, render_labels(), _fmt(child.value)))
        return "\n".join(lines) + "\n"


#: the process-wide default registry: the runner, the input pipeline and the
#: live exporter report through this one unless a caller injects its own
#: (tests do)
REGISTRY = MetricsRegistry()

#: Content-Type of the text exposition
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# --------------------------------------------------------------------- #
# text-format round-trip (tests + chip_smoke.py)

_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value):
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(text):
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    return float(text)  # float("NaN") handles NaN

def parse_prometheus(text):
    """Parse text exposition into
    ``{name: {"type": t, "help": h, "samples": [(labels_dict, value)]}}``.

    A deliberately strict, minimal parser: any non-comment non-empty line
    that does not match the sample grammar raises ``ValueError`` — which is
    exactly what the round-trip tests and the smoke script want (a format
    regression must fail the scrape, not parse loosely)."""
    metrics = {}
    current = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            metrics.setdefault(name, {"type": None, "help": "", "samples": []})
            metrics[name]["help"] = help_text
            current = name
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            metrics.setdefault(name, {"type": None, "help": "", "samples": []})
            metrics[name]["type"] = kind.strip()
            current = name
            continue
        if line.startswith("#"):
            continue
        match = _SAMPLE.match(line)
        if not match:
            raise ValueError("Unparseable exposition line: %r" % raw)
        sample_name = match.group("name")
        labels = {}
        label_text = match.group("labels")
        if label_text:
            # strict walk: label pairs separated by single commas, nothing
            # between them (finditer would skip garbage separators)
            pos = 0
            while pos < len(label_text):
                lm = _LABEL.match(label_text, pos)
                if lm is None:
                    raise ValueError("Unparseable labels in line: %r" % raw)
                labels[lm.group(1)] = _unescape(lm.group(2))
                pos = lm.end()
                if pos < len(label_text):
                    if label_text[pos] != ",":
                        raise ValueError("Unparseable labels in line: %r" % raw)
                    pos += 1  # trailing comma before "}" is legal
        # histogram series (_bucket/_sum/_count) attach to their family
        family = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[: -len(suffix)] if sample_name.endswith(suffix) else None
            if base and base in metrics and metrics[base]["type"] == "histogram":
                family = base
                break
        metrics.setdefault(family, {"type": None, "help": "", "samples": []})
        metrics[family]["samples"].append(
            (sample_name, labels, _parse_value(match.group("value")))
        )
        current = family
    del current
    return metrics
