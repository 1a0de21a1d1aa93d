"""Fleet postmortem runner: replay N journals as one verified story.

Counterpart of ``aggregathor_tpu/cli/postmortem.py``, with its options
and defaults; the report is the same document.

The causal plane's operator door (``obs/causal.py``): point it at every journal a run left behind —
trainer, serve replicas, router, supervisor — and it merges them into one
causally ordered timeline, audits the cause-reference DAG (dangling
edges, orphan actuations, unanswered spawn chains, rollbacks that fail to
name their sentinel verdict) and writes the
``aggregathor.obs.postmortem.v1`` report plus a markdown story.

**The exit code IS the verdict**: 0 when every chain closes and every
reference resolves, 1 when the journals cannot carry the story they
claim (including a journal that fails to load — a truncated file is
destroyed evidence, not a smaller story).

Example::

  python -m aggregathor_tpu_torch.cli.postmortem \
      --journal train=out/train.jsonl --journal router=out/router.jsonl \
      --journal supervisor=out/supervisor.jsonl \
      --report out/postmortem.json --story out/postmortem.md
"""

import argparse
import json
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        prog="aggregathor-tpu postmortem",
        description="merge + audit fleet journals into one verified story "
                    "(exit code 0 = every causal chain closes)",
    )
    parser.add_argument("--journal", action="append", default=[],
                        required=True, metavar="NAME=PATH",
                        help="one instance's journal (repeatable); NAME must "
                             "match the instance name cause references use "
                             "(the supervisor's --instance-name, the "
                             "router's instance_name)")
    parser.add_argument("--report", default=None, metavar="JSON",
                        help="write the aggregathor.obs.postmortem.v1 report "
                             "here (default: stdout)")
    parser.add_argument("--story", default=None, metavar="MD",
                        help="write the markdown story here")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress the stdout report when --report is "
                             "given")
    return parser


def parse_sources(specs):
    from ..utils import UserException

    sources = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise UserException("--journal %r: expected NAME=PATH" % spec)
        if name in sources:
            raise UserException("--journal: name %r given twice" % name)
        sources[name] = path
    return sources


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..obs import causal
    from ..utils import info, warning

    sources = parse_sources(args.journal)
    report = causal.run_postmortem(sources,
                                   include_timeline=bool(args.story))
    timeline = report.pop("timeline", None)
    body = json.dumps(report, indent=2, sort_keys=True)
    if args.report:
        with open(args.report, "w") as fd:
            fd.write(body + "\n")
        info("Postmortem report -> %r" % (args.report,))
    if args.report is None or not args.quiet:
        print(body)
    if args.story:
        with open(args.story, "w") as fd:
            fd.write(causal.render_story(report, timeline))
        info("Postmortem story -> %r" % (args.story,))
    if report["verdict"] != "PASS":
        warning("Postmortem verdict: FAIL (%s)"
                % ", ".join(report["failing"]))
        return 1
    info("Postmortem verdict: PASS (%d event(s), %d edge(s), %d chain(s))"
         % (report["events_total"], report["edges_total"],
            len(report["chains"])))
    return 0


def cli():
    from . import console_entry

    return console_entry(main)


if __name__ == "__main__":
    sys.exit(cli())
