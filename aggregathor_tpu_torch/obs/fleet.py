"""One-scrape fleet federation: N processes' telemetry behind one port.

A copy of ``aggregathor_tpu/obs/fleet.py`` (the module imports no JAX).
:class:`FleetCollector` polls N child endpoints (training runs'
``--live-port`` exporters, serving processes) on a cadence and serves, from
one port:

- ``GET /fleet/metrics``  every child's last-held exposition merged under a
  per-instance ``instance`` label, plus fleet-level sums for
  counter/histogram series under ``instance="_fleet"``, plus the
  collector's own meta family (``fleet_instance_up`` / ``_stale`` /
  ``fleet_last_scrape_age_seconds`` / ``fleet_polls_total`` /
  ``fleet_scrape_errors_total``);
- ``GET /fleet/status``   per-instance up/down, miss counts, scrape age and
  the child's own ``/status`` body;
- ``GET /fleet/journal``  the instances' causal run journals merged into
  one timeline (``obs/causal.py``);
- ``GET /healthz``        collector liveness.

**Down is explicit, never silent.**  An instance that misses
``down_after`` consecutive polls is marked ``down`` and its LAST sample is
HELD under an explicit staleness marker, so killing a serving process
cannot make the fleet's counter sums jump backwards.  Everything
decision-shaped is injectable (``fetch``, ``clock``).

Run standalone::

    python -m aggregathor_tpu_torch.obs.fleet --port 9100 \\
        --instance train=127.0.0.1:9000 --instance serve=127.0.0.1:8000 \\
        --journal train=/tmp/run.journal.jsonl
"""

import argparse
import json
import os
import signal
import sys
import threading
import time
import urllib.parse
import urllib.request

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import events as obs_events
from . import metrics as obs_metrics
from ..utils import UserException, info


def _default_fetch(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as response:
        return response.read().decode()


class _Instance:
    """One child endpoint's scrape state (collector-internal)."""

    __slots__ = ("name", "url", "journal_path", "metrics", "status",
                 "last_ok_at", "misses", "last_error", "ever_seen")

    def __init__(self, name, url, journal_path=None):
        self.name = name
        self.url = url
        self.journal_path = journal_path
        self.metrics = None      # parse_prometheus output, last success
        self.status = None       # /status JSON body, last success
        self.last_ok_at = None   # collector clock at last success
        self.misses = 0          # consecutive failed polls
        self.last_error = None
        self.ever_seen = False


class FleetCollector:
    """Polls child ``/metrics`` + ``/status`` endpoints; merges + serves.

    Args:
      instances: ``{name: base_url}`` — ``host:port`` is normalized to
        ``http://host:port``.  Names become the ``instance`` label.
      journal_paths: optional ``{name: journal_jsonl_path}`` merged by
        ``/fleet/journal`` (names need not match ``instances`` — a journal
        may belong to a process that exports no metrics).
      down_after: consecutive missed polls before an instance reads
        ``down`` (its last sample is then HELD under the staleness marker,
        never dropped).
      timeout: per-request fetch timeout (seconds).
      fetch: injectable ``fetch(url, timeout) -> text`` (tests).
      clock: injectable monotonic clock (ages, tests).
    """

    def __init__(self, instances, journal_paths=None, down_after=3,
                 timeout=2.0, fetch=None, clock=None):
        if not instances:
            raise UserException("FleetCollector wants at least one instance")
        if int(down_after) < 1:
            raise UserException("down_after must be >= 1 poll")
        self.down_after = int(down_after)
        self.timeout = float(timeout)
        self.fetch = fetch if fetch is not None else _default_fetch
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._instances = {}
        for name, url in instances.items():
            if "://" not in url:
                url = "http://" + url
            self._instances[str(name)] = _Instance(
                str(name), url.rstrip("/"),
                (journal_paths or {}).get(name),
            )
        for name, path in (journal_paths or {}).items():
            if name not in self._instances:
                self._instances[str(name)] = _Instance(str(name), None, path)
        self.polls_total = 0
        self.errors_total = {name: 0 for name in self._instances}
        self._thread = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ #
    # polling

    def poll_once(self):
        """Scrape every instance once.  A child's failure degrades THAT
        child (miss counted, last sample held); it never raises."""
        with self._lock:
            self.polls_total += 1
            targets = [i for i in self._instances.values() if i.url is not None]
        for inst in targets:
            try:
                # explicit ?format=prometheus: bare /metrics serves text on
                # every exporter, and the explicit form also reads text
                # from older serve processes that default to JSON
                text = self.fetch(
                    inst.url + "/metrics?format=prometheus", self.timeout
                )
                parsed = obs_metrics.parse_prometheus(text)
                status = json.loads(self.fetch(inst.url + "/status", self.timeout))
            except Exception as exc:
                with self._lock:
                    inst.misses += 1
                    inst.last_error = "%s: %s" % (type(exc).__name__, exc)
                    self.errors_total[inst.name] += 1
                continue
            with self._lock:
                inst.metrics = parsed
                inst.status = status
                inst.last_ok_at = self.clock()
                inst.misses = 0
                inst.last_error = None
                inst.ever_seen = True

    def instance_up(self, name):
        """True while ``name`` has a fresh sample (fewer than
        ``down_after`` consecutive misses since its last success)."""
        with self._lock:
            inst = self._instances[name]
            return inst.ever_seen and inst.misses < self.down_after

    # ------------------------------------------------------------------ #
    # merged readout

    def render_metrics(self):
        """The one-scrape exposition (Prometheus text format 0.0.4)."""
        now = self.clock()
        with self._lock:
            snapshot = [
                (inst.name, inst.url, inst.metrics, inst.last_ok_at,
                 inst.misses, inst.ever_seen)
                for inst in self._instances.values() if inst.url is not None
            ]
            polls = self.polls_total
            errors = dict(self.errors_total)
        lines = []

        def sample(name, labels, value):
            rendered = ",".join(
                '%s="%s"' % (k, obs_metrics.escape_label_value(v))
                for k, v in labels
            )
            lines.append("%s{%s} %s" % (name, rendered, obs_metrics._fmt(value)))

        # collector meta family: up/stale/age per instance + poll counters
        lines.append("# HELP fleet_instance_up 1 while the instance's last "
                     "poll cycle succeeded recently")
        lines.append("# TYPE fleet_instance_up gauge")
        for name, _url, _metrics, _ok_at, misses, seen in snapshot:
            sample("fleet_instance_up", [("instance", name)],
                   1.0 if (seen and misses < self.down_after) else 0.0)
        lines.append("# HELP fleet_instance_stale 1 while a down instance's "
                     "last sample is being HELD (never silently dropped)")
        lines.append("# TYPE fleet_instance_stale gauge")
        for name, _url, metrics, _ok_at, misses, seen in snapshot:
            stale = seen and misses >= self.down_after and metrics is not None
            sample("fleet_instance_stale", [("instance", name)],
                   1.0 if stale else 0.0)
        lines.append("# HELP fleet_last_scrape_age_seconds Seconds since the "
                     "instance's last successful scrape")
        lines.append("# TYPE fleet_last_scrape_age_seconds gauge")
        for name, _url, _metrics, ok_at, _misses, _seen in snapshot:
            sample("fleet_last_scrape_age_seconds", [("instance", name)],
                   float("inf") if ok_at is None else max(0.0, now - ok_at))
        lines.append("# HELP fleet_polls_total Poll cycles run by the collector")
        lines.append("# TYPE fleet_polls_total counter")
        lines.append("fleet_polls_total %s" % obs_metrics._fmt(polls))
        lines.append("# HELP fleet_scrape_errors_total Failed instance scrapes")
        lines.append("# TYPE fleet_scrape_errors_total counter")
        for name in sorted(errors):
            sample("fleet_scrape_errors_total", [("instance", name)],
                   float(errors[name]))

        # child families, merged: per-instance labels on every sample, plus
        # the fleet sum (instance="_fleet") for counter/histogram series —
        # held samples of down instances INCLUDED, so a killed process
        # cannot make a fleet counter jump backwards
        families = {}
        for name, _url, metrics, _ok_at, _misses, _seen in snapshot:
            if metrics is None:
                continue
            for fname, family in metrics.items():
                entry = families.setdefault(
                    fname, {"type": family.get("type"),
                            "help": family.get("help", ""), "rows": []}
                )
                if entry["type"] is None:
                    entry["type"] = family.get("type")
                for sample_name, labels, value in family["samples"]:
                    entry["rows"].append((name, sample_name, labels, value))
        for fname in sorted(families):
            entry = families[fname]
            kind = entry["type"] or "untyped"
            lines.append("# HELP %s %s" % (fname, entry["help"]))
            lines.append("# TYPE %s %s" % (fname, kind))
            sums = {}
            for inst_name, sample_name, labels, value in entry["rows"]:
                ordered = [("instance", inst_name)] + sorted(labels.items())
                sample(sample_name, ordered, value)
                if kind in ("counter", "histogram"):
                    key = (sample_name, tuple(sorted(labels.items())))
                    sums[key] = sums.get(key, 0.0) + value
            for (sample_name, labels), total in sorted(sums.items()):
                sample(sample_name, [("instance", "_fleet")] + list(labels),
                       total)
        return "\n".join(lines) + "\n"

    def status_payload(self):
        """The ``/fleet/status`` JSON body."""
        now = self.clock()
        with self._lock:
            payload = {
                "polls": self.polls_total,
                "down_after": self.down_after,
                "generated_at": time.time(),
                "instances": {},
            }
            for inst in self._instances.values():
                up = inst.ever_seen and inst.misses < self.down_after
                payload["instances"][inst.name] = {
                    "url": inst.url,
                    "up": up,
                    "stale": bool(inst.ever_seen and not up),
                    "misses": inst.misses,
                    # the exact down-judgment inputs a restart decision
                    # needs: misses under its canonical name (the down
                    # threshold is consecutive_misses >= down_after) next
                    # to the freshness age — supervisor/policy.py reads
                    # these, "misses" stays for older scrapers
                    "consecutive_misses": inst.misses,
                    "last_scrape_age_seconds": (
                        None if inst.last_ok_at is None
                        else max(0.0, now - inst.last_ok_at)
                    ),
                    "last_error": inst.last_error,
                    "journal": inst.journal_path,
                    "status": inst.status,
                }
        return payload

    def journal_payload(self):
        """The ``/fleet/journal`` JSON body: every configured journal
        loaded through the validator (obs/events.py) and merged into one
        causally ordered timeline (obs/causal.py ``merge_streams``: wall
        clock + ``(t_wall, instance)`` tie-break where no ``cause`` edge
        says otherwise, edges respected where one does — an effect never
        precedes its cited cause, and a wall-clock inversion between
        hosts is reported as measured ``skew`` rather than crashed on),
        each event stamped with its instance.  A missing/garbled journal
        degrades to a per-instance error entry — one bad file must not
        hide the others' timeline."""
        from . import causal

        with self._lock:
            sources = [
                (inst.name, inst.journal_path)
                for inst in self._instances.values()
                if inst.journal_path is not None
            ]
        streams, per_instance = {}, {}
        for name, path in sources:
            try:
                records = obs_events.load_journal(path)
            except FileNotFoundError:
                per_instance[name] = {"path": path, "events": 0,
                                      "error": "journal not written yet"}
                continue
            except (OSError, ValueError) as exc:
                # permission denied, path-is-a-directory, garbled bytes —
                # all degrade to a per-instance error entry (one bad file
                # must not hide the others' timeline)
                per_instance[name] = {"path": path, "events": 0,
                                      "error": "%s: %s" % (type(exc).__name__,
                                                           exc)}
                continue
            per_instance[name] = {
                "path": path, "events": len(records),
                "by_type": obs_events.counts_by_type(records),
            }
            streams[name] = records
        merged, merge_report = causal.merge_streams(streams)
        return {
            "schema": obs_events.SCHEMA,
            "instances": per_instance,
            "events": merged,
            "skew": {"pairs": merge_report["skew_pairs"],
                     "forced_order": merge_report["forced_order"]},
        }

    # ------------------------------------------------------------------ #
    # poll loop lifecycle

    def start(self, interval_s=1.0):
        """Poll every ``interval_s`` seconds on a daemon thread (one
        immediate poll first, so the endpoint is populated at ready time)."""
        if interval_s <= 0.0:
            raise UserException("fleet poll interval must be > 0 seconds")
        if self._thread is not None:
            return
        self.poll_once()

        def run():
            while not self._stop.wait(interval_s):
                self.poll_once()

        self._thread = threading.Thread(
            target=run, daemon=True, name="fleet-collector"
        )
        self._thread.start()

    def close(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5.0)


# --------------------------------------------------------------------- #
# the one-port HTTP front


class _Handler(BaseHTTPRequestHandler):
    server_version = "aggregathor-fleet/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass

    def _reply(self, code, body, content_type):
        body = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urllib.parse.urlsplit(self.path).path
        collector = self.server.collector
        try:
            if path == "/fleet/metrics":
                self._reply(200, collector.render_metrics(),
                            obs_metrics.PROMETHEUS_CONTENT_TYPE)
            elif path == "/fleet/status":
                self._reply(200, json.dumps(collector.status_payload()),
                            "application/json")
            elif path == "/fleet/journal":
                self._reply(200, json.dumps(collector.journal_payload()),
                            "application/json")
            elif path == "/healthz":
                self._reply(200, json.dumps({"status": "ok"}),
                            "application/json")
            else:
                self._reply(404, json.dumps({"error": "unknown path %r" % path}),
                            "application/json")
        except Exception as exc:  # a scrape must never kill the collector
            self._reply(500, json.dumps(
                {"error": "%s: %s" % (type(exc).__name__, exc)}
            ), "application/json")


class FleetServer(ThreadingHTTPServer):
    """The collector's HTTP face (``serve_background`` / ``shutdown_all``,
    the LiveExporter lifecycle)."""

    daemon_threads = True

    def __init__(self, collector, host="127.0.0.1", port=0):
        super().__init__((host, int(port)), _Handler)
        self.collector = collector
        self._serve_thread = None

    def serve_background(self):
        self._serve_thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="fleet-server"
        )
        self._serve_thread.start()
        host, port = self.server_address[:2]
        info("Fleet collector on http://%s:%d (/fleet/metrics, /fleet/status, "
             "/fleet/journal)" % (host, port))
        return host, port

    def shutdown_all(self):
        self.shutdown()
        self.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5.0)
            self._serve_thread = None


# --------------------------------------------------------------------- #
# CLI


def _parse_pairs(specs, what):
    out = {}
    for spec in specs:
        name, sep, value = spec.partition("=")
        if not sep or not name or not value:
            raise UserException(
                "--%s wants NAME=%s, got %r" % (what, what.upper(), spec)
            )
        if name in out:
            raise UserException("--%s %r given twice" % (what, name))
        out[name] = value
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m aggregathor_tpu_torch.obs.fleet",
        description="One-scrape fleet federation over N /metrics + /status "
                    "endpoints (docs/observability.md 'The control room')",
    )
    parser.add_argument("--instance", action="append", default=[],
                        metavar="NAME=HOST:PORT",
                        help="child endpoint to federate (repeatable)")
    parser.add_argument("--journal", action="append", default=[],
                        metavar="NAME=PATH",
                        help="causal run journal served by /fleet/journal "
                             "(repeatable; NAME need not be an --instance)")
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument("--port", type=int, default=0,
                        help="bind port (0 = ephemeral)")
    parser.add_argument("--poll-interval", type=float, default=1.0,
                        help="seconds between poll cycles")
    parser.add_argument("--down-after", type=int, default=3,
                        help="consecutive missed polls before an instance "
                             "reads down (its last sample is held, marked "
                             "stale)")
    parser.add_argument("--timeout", type=float, default=2.0,
                        help="per-request scrape timeout (seconds)")
    parser.add_argument("--ready-file", default=None, metavar="PATH",
                        help="write 'host port pid' here once bound and the "
                             "first poll cycle ran (harness handshake)")
    args = parser.parse_args(argv)
    instances = _parse_pairs(args.instance, "instance")
    journals = _parse_pairs(args.journal, "journal")
    if not instances:
        parser.error("at least one --instance NAME=HOST:PORT is required")

    collector = FleetCollector(
        instances, journal_paths=journals, down_after=args.down_after,
        timeout=args.timeout,
    )
    server = FleetServer(collector, host=args.host, port=args.port)
    stop = threading.Event()

    def on_signal(signum, frame):
        info("Signal %d: fleet collector shutting down" % signum)
        stop.set()

    previous = {
        signal.SIGINT: signal.signal(signal.SIGINT, on_signal),
        signal.SIGTERM: signal.signal(signal.SIGTERM, on_signal),
    }
    try:
        collector.start(args.poll_interval)
        host, port = server.serve_background()
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as fd:
                fd.write("%s %d %d\n" % (host, port, os.getpid()))
            os.replace(tmp, args.ready_file)
        stop.wait()
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)
        collector.close()
        server.shutdown_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
