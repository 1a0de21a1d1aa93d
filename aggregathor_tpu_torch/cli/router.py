"""Fleet router runner: ONE admission port in front of N serving processes.

Counterpart of ``aggregathor_tpu/cli/router.py``, with its options.  Point
it at N independent ``cli/serve.py`` processes following the same
snapshot stream and it serves ``POST /predict`` on a single port
(``serve/router.py``): the least-in-flight policy with the
fleet-consistent ``weights_step`` guarantee, fleet-decision shed (429 only
when EVERY healthy backend is saturated), drain re-routing and
exactly-once re-dispatch when a backend dies mid-flight.  Health and
pressure come from an embedded
:class:`~aggregathor_tpu_torch.obs.fleet.FleetCollector` (``--poll-interval``
/ ``--down-after``); with ``--journal`` every routing decision lands in
the causal run journal.

Example (two backends, one door)::

  python -m aggregathor_tpu_torch.cli.router \\
      --backend a=127.0.0.1:8000 --backend b=127.0.0.1:8001 \\
      --port 8100 --journal out/router_journal.jsonl
"""

import argparse
import os
import signal
import sys
import threading


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-torch router",
        description="fleet admission + routing in front of replicated serving",
    )
    parser.add_argument("--backend", action="append", default=[], required=True,
                        metavar="NAME=HOST:PORT",
                        help="one serving backend (repeatable); NAME keys the "
                             "journal/metrics, HOST:PORT its /predict surface")
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument("--port", type=int, default=8100,
                        help="admission port (0 = ephemeral)")
    parser.add_argument("--poll-interval", type=float, default=0.5, metavar="S",
                        help="fleet scrape period (health/pressure sampling)")
    parser.add_argument("--down-after", type=int, default=3, metavar="N",
                        help="consecutive scrape misses before a backend reads "
                             "down (a failed forward latches it out immediately)")
    parser.add_argument("--scrape-timeout", type=float, default=2.0, metavar="S",
                        help="per-backend scrape fetch timeout")
    parser.add_argument("--request-timeout", type=float, default=60.0, metavar="S",
                        help="forward timeout for /predict (must exceed the "
                             "backends' own batch wait)")
    parser.add_argument("--step-wait", type=float, default=5.0, metavar="S",
                        help="how long a step-pinned request may wait out a "
                             "swap window before 503 (consistency over "
                             "availability, bounded)")
    parser.add_argument("--ready-file", default=None, metavar="PATH",
                        help="write 'host port pid' here once the first fleet "
                             "scrape ran AND the port is bound (harness handshake)")
    parser.add_argument("--journal", default=None, metavar="JSONL",
                        help="causal run journal (obs/events.py): append every "
                             "routing decision as typed JSONL (schema "
                             "aggregathor.obs.events.v2)")
    parser.add_argument("--run-id", default=None, metavar="ID",
                        help="run id stamped on journal lines (default: generated)")
    from . import add_causal_flags

    add_causal_flags(parser)
    return parser


def parse_backends(specs):
    from ..utils import UserException

    backends = {}
    for spec in specs:
        name, sep, url = spec.partition("=")
        if not sep or not name or not url:
            raise UserException(
                "--backend %r: expected NAME=HOST:PORT" % spec)
        if name in backends:
            raise UserException("--backend: name %r given twice" % name)
        backends[name] = url
    return backends


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..obs import events as obs_events
    from ..obs.summaries import make_run_id
    from ..serve import FleetRouter, RouterServer
    from ..utils import info

    from . import parse_cause_flag

    backends = parse_backends(args.backend)
    run_id = args.run_id if args.run_id else make_run_id()
    cause = parse_cause_flag(args.cause)
    if args.journal:
        obs_events.install(args.journal, run_id=run_id,
                           max_bytes=args.journal_max_bytes)
        obs_events.emit("run_start", role="router",
                        backends=sorted(backends), pid=os.getpid(),
                        cause=cause)
        info("Run journal to %r (run_id %s)" % (args.journal, run_id))

    router = FleetRouter(
        backends,
        poll_interval=args.poll_interval,
        down_after=args.down_after,
        timeout=args.scrape_timeout,
        request_timeout_s=args.request_timeout,
        step_wait_s=args.step_wait,
    )
    server = RouterServer(router, host=args.host, port=args.port)

    stop = threading.Event()

    def on_signal(signum, frame):
        info("Signal %d: router shutting down" % signum)
        stop.set()

    previous = {
        signal.SIGINT: signal.signal(signal.SIGINT, on_signal),
        signal.SIGTERM: signal.signal(signal.SIGTERM, on_signal),
    }
    try:
        router.start()  # one scrape up front: the first request sees the fleet
        host, port = server.serve_background()
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as fd:
                fd.write("%s %d %d\n" % (host, port, os.getpid()))
            os.replace(tmp, args.ready_file)  # atomic: never a torn line
        info("Routing %d backend(s): %s"
             % (len(backends), ", ".join(sorted(backends))))
        stop.wait()
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)
        server.shutdown_all()
        router.close()
        if args.journal and obs_events.installed() is not None:
            obs_events.emit("run_end", role="router")
            written = obs_events.uninstall()
            info("Run journal -> %r (run_id %s)" % (written, run_id))
    return 0


def cli():
    """Console entry: UserException -> clean error + exit code 1."""
    from ..utils import UserException, error

    try:
        return main()
    except UserException as exc:
        error(str(exc))
        return 1


if __name__ == "__main__":
    sys.exit(cli())
