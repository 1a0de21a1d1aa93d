"""Fleet supervisor runner: the self-driving run.

Counterpart of ``aggregathor_tpu/cli/supervise.py``, with its options
and defaults.

Point it at a fleet spec (JSON: the instances' argvs, scrape URLs,
journals, sentinel verdict files, checkpoint directories and retune
ladders) and it spawns the fleet and closes the control loop the control
room opened: every tick it scrapes health (obs/fleet.py), tails the
instances' causal journals (incremental cursors — obs/events.py
``tail_journal``) and reads fresh sentinel verdicts (obs/slo.py), feeds
them to the pure :class:`~aggregathor_tpu_torch.supervisor.SupervisorPolicy`,
and executes the returned actions: restart dead/hung instances under
exponential backoff, quarantine crash-loopers, retune knobs through an
argv rebuild + graceful restart, roll checkpoint timelines back through
the custody path on REGRESS — every action a typed
``supervisor_*`` journal event with its triggering evidence.

Example::

  python -m aggregathor_tpu_torch.cli.supervise \
      --fleet out/fleet.json --journal out/supervisor.jsonl \
      --tick-interval 0.5 --supervisor-args patience:3 max-restarts:4
"""

import argparse
import os
import signal
import sys
import threading


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-tpu supervise",
        description="fleet supervisor: restart, retune and roll back a "
                    "train+serve+router fleet with zero human action",
    )
    parser.add_argument("--fleet", required=True, metavar="JSON",
                        help="fleet spec file: {\"instances\": [{name, role, "
                             "argv, url/ready_file, journal, verdict, "
                             "checkpoint_dir, retunes, ...}, ...]}")
    parser.add_argument("--tick-interval", type=float, default=1.0, metavar="S",
                        help="seconds between sense->decide->act rounds")
    parser.add_argument("--down-after", type=int, default=3, metavar="N",
                        help="consecutive scrape misses before an instance "
                             "reads down (the restart trigger for hangs)")
    parser.add_argument("--scrape-timeout", type=float, default=2.0, metavar="S",
                        help="per-instance scrape fetch timeout")
    parser.add_argument("--supervisor-args", nargs="*", default=[],
                        metavar="KEY:VALUE",
                        help="policy knobs: patience, backoff, max-restarts, "
                             "flap-window, retune-streak, retune-cooldown "
                             "(supervisor/policy.py)")
    parser.add_argument("--max-ticks", type=int, default=None, metavar="N",
                        help="exit after N ticks (smokes; default: run until "
                             "SIGTERM/SIGINT)")
    parser.add_argument("--ready-file", default=None, metavar="PATH",
                        help="write 'host port pid' (host/port are 0: the "
                             "supervisor serves nothing) once the fleet is "
                             "spawned (harness handshake)")
    parser.add_argument("--journal", default=None, metavar="JSONL",
                        help="the supervisor's own causal journal: every "
                             "supervisor_* action with its evidence")
    parser.add_argument("--run-id", default=None, metavar="ID",
                        help="run id stamped on journal lines (default: "
                             "generated)")
    parser.add_argument("--keep-fleet", action="store_true",
                        help="leave the fleet running on exit (default: "
                             "SIGTERM every instance the supervisor spawned)")
    parser.add_argument("--instance-name", default="supervisor", metavar="NAME",
                        help="this supervisor's name in cross-journal cause "
                             "references (children spawned by an action cite "
                             "NAME:RUN_ID:SEQ; may not contain ':')")
    from . import add_causal_flags

    add_causal_flags(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..obs import events as obs_events
    from ..obs.summaries import make_run_id
    from ..supervisor import FleetSupervisor, SupervisorConfig
    from ..supervisor.actuator import load_fleet_spec
    from ..utils import info

    from . import parse_cause_flag

    specs = load_fleet_spec(args.fleet)
    config = SupervisorConfig(args.supervisor_args)
    run_id = args.run_id if args.run_id else make_run_id()
    cause = parse_cause_flag(args.cause)
    if args.journal:
        obs_events.install(args.journal, run_id=run_id,
                           max_bytes=args.journal_max_bytes)
        obs_events.emit("run_start", role="supervisor",
                        instances=sorted(s.name for s in specs),
                        config=config.describe(), pid=os.getpid(),
                        cause=cause)
        info("Run journal to %r (run_id %s)" % (args.journal, run_id))

    supervisor = FleetSupervisor(
        specs, config=config, down_after=args.down_after,
        scrape_timeout=args.scrape_timeout,
        instance_name=args.instance_name,
    )

    stop = threading.Event()

    def on_signal(signum, frame):
        info("Signal %d: supervisor shutting down" % signum)
        stop.set()

    previous = {
        signal.SIGINT: signal.signal(signal.SIGINT, on_signal),
        signal.SIGTERM: signal.signal(signal.SIGTERM, on_signal),
    }
    try:
        supervisor.start()
        if args.ready_file:
            tmp = args.ready_file + ".tmp"
            with open(tmp, "w") as fd:
                fd.write("0 0 %d\n" % os.getpid())
            os.replace(tmp, args.ready_file)  # atomic: never a torn line
        info("Supervising %d instance(s): %s (%s)"
             % (len(specs), ", ".join(sorted(s.name for s in specs)),
                config.describe()))
        ticks = supervisor.run(
            tick_interval=args.tick_interval,
            should_stop=stop.is_set,
            max_ticks=args.max_ticks,
        )
        info("Supervisor loop ended after %d tick(s)" % ticks)
    finally:
        for signum, handler in previous.items():
            signal.signal(signum, handler)
        if not args.keep_fleet:
            supervisor.stop()
        if args.journal and obs_events.installed() is not None:
            obs_events.emit("run_end", role="supervisor")
            written = obs_events.uninstall()
            info("Run journal -> %r (run_id %s)" % (written, run_id))
    return 0


def cli():
    from . import console_entry

    return console_entry(main)


if __name__ == "__main__":
    sys.exit(cli())
