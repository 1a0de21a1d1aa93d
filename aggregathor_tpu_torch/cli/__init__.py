"""Command-line entry points: the training runner (``python -m
aggregathor_tpu_torch.cli.runner``), ``deploy``, ``serve``, ``router``,
``supervise`` and ``postmortem``."""


def console_entry(main):
    """Run a CLI's main: a UserException becomes a clean error and exit
    code 1 (JAX ``cli/__init__.py:11``)."""
    from ..utils import UserException, error

    try:
        return main()
    except UserException as exc:
        error(str(exc))
        return 1


def add_causal_flags(parser):
    """The causal-plane flags of the JAX package's journaling CLIs
    (``aggregathor_tpu/cli/__init__.py``): ``--cause`` makes this process's
    ``run_start`` cite the journal event that spawned it,
    ``--journal-max-bytes`` bounds one journal file by segment rotation
    (``obs/events.py`` ``Journal(max_bytes=...)``)."""
    parser.add_argument("--cause", default=None, metavar="INSTANCE:RUN_ID:SEQ",
                        help="cause reference stamped on this run's run_start "
                             "event: the journal event that spawned this "
                             "process (cli.postmortem replays the chain)")
    parser.add_argument("--journal-max-bytes", type=int, default=None,
                        metavar="N",
                        help="rotate the journal after the write crossing N "
                             "bytes; rolled segments become PATH.1, PATH.2, "
                             "... (default: never rotate)")
    return parser


def parse_cause_flag(token):
    """``--cause`` token -> cause reference dict (or None).  A garbled
    token fails the launch (UserException), never the journal: an
    operator's typo must be loud, not a dangling reference."""
    from ..obs import events as obs_events
    from ..utils import UserException

    if token is None:
        return None
    try:
        return obs_events.parse_cause(token)
    except ValueError as exc:
        raise UserException("--cause: %s" % (exc,))
