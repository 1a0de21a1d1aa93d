"""The port's guardian (``aggregathor_tpu_torch/guardian``) and the runner's
rollback-and-escalate held against the JAX package.

Policy (no runner):
- one script of ``(step, loss, finite, spike)`` observations and rollbacks
  through both ``Watchdog``s -- a non-finite loss, spikes below and above
  ``patience``, the cooldown and its backoff, recovery, exhaustion, the
  timeout and ceiling inputs -- gives the same decisions, attempts,
  cooldown horizons and reasons, and byte-identical journals;
- every rung string of JAX ``tests/test_guardian.py:146-181``, the bad ones
  included, parses or refuses alike (an unknown rule's text names each
  package's own registry), and the rungs applied
  in turn give the same ``Overrides.describe()``; ``GuardianConfig``
  refuses the same arguments.

The runner (mnist, batch 16, at most 30 steps):
- the argv of the parity leg (average, n = 8, f = 2, r = 2 ``inf``, the
  default ladder, ``recover:5``) gives the JAX runner's guardian timeline:
  summary events, the journal's event types with their guardian fields,
  and the three ``guardian_*_total`` counters;
- while healthy, ``--guardian`` changes no loss; a resume into a hostile
  regime rolls back to the auto-restored snapshot; an unsurvivable regime
  fails after its retries; ``--guardian`` needs ``--checkpoint-dir``; a
  recovered run ends within 1.10x of a median run from step 0; a rollback
  under ``--unroll 4 --prefetch 2`` rebuilds the chunk pipeline and
  repeats the ``--prefetch 0`` losses;
- the reference's compatibility flags map or refuse as stated, and
  ``can_access`` answers as the JAX function does.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from aggregathor_tpu import gars as jgars, guardian as jguardian
from aggregathor_tpu.cli import runner as jrunner
from aggregathor_tpu.obs import events as jevents, metrics as jmetrics
from aggregathor_tpu.utils import UserException as JaxUserException, can_access as jax_can_access
from aggregathor_tpu_torch import gars as tgars, guardian as tguardian
from aggregathor_tpu_torch.cli import runner
from aggregathor_tpu_torch.models import datasets
from aggregathor_tpu_torch.obs import events as tevents, metrics as tmetrics
from aggregathor_tpu_torch.obs.checkpoint import Checkpoints
from aggregathor_tpu_torch.parallel import RobustEngine
from aggregathor_tpu_torch.utils import UserException, can_access

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)

PACKAGES = (("jax", jguardian, jevents), ("port", tguardian, tevents))
JAX_REGISTERED = " (registered: %s)" % ", ".join(sorted(jgars.itemize()))


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    jevents.uninstall()
    tevents.uninstall()


def _outcome(fn):
    try:
        return ("ok", fn())
    except (UserException, JaxUserException) as exc:
        return ("raised", str(exc))


def _clocks():
    ticks = iter(range(10_000))
    return (lambda: 1_792_000_000.0 + next(ticks)), (lambda: float(next(ticks)))


# --------------------------------------------------------------------- #
# the watchdog and the ladder

#: (guardian args, script): ("obs", step, loss, finite, spike),
#: ("timeouts", step, nb, budget), ("ceiling", step, at_ceiling),
#: ("rollback", restore step)
WATCHDOG_SCRIPTS = {
    "spikes-cooldown-recovery-exhaustion": (["patience:3", "spike:10.0", "recover:2", "retries:3", "backoff:2"], [
        ("obs", 1, 1.0, True, 1.0),
        ("obs", 2, 50.0, True, 50.0), ("obs", 3, 50.0, True, 50.0),   # below patience
        ("obs", 4, 1.0, True, 1.0),                                    # the streak resets
        ("obs", 5, 50.0, True, 50.0), ("obs", 6, 50.0, True, 50.0), ("obs", 7, 50.0, True, 50.0),  # rollback
        ("rollback", 4),                                               # cooldown to 4 + 3*2
        ("obs", 5, 60.0, True, 60.0), ("obs", 6, 60.0, True, 60.0), ("obs", 7, 60.0, True, 60.0),
        ("obs", 8, 60.0, True, 60.0), ("obs", 9, 60.0, True, 60.0),    # spikes inside the cooldown
        ("obs", 10, 60.0, True, 60.0),                                 # past it: rollback
        ("rollback", 4),                                               # backoff: 4 + 3*4
        ("obs", 5, 2.0, True, 2.0), ("obs", 6, 2.0, True, 2.0),        # recovered
        ("obs", 7, 2.0, True, 2.0),
        ("obs", 8, float("nan"), False, float("inf")),                 # non-finite: at once
        ("rollback", 0), ("obs", 1, 1.0, True, 1.0),
    ]),
    "non-finite-ignores-cooldown": (["retries:2", "recover:3"], [
        ("obs", 1, 1.0, True, 1.0), ("obs", 2, float("nan"), False, float("inf")), ("rollback", 0),
        ("obs", 1, float("inf"), False, float("inf")), ("rollback", 0),
        ("obs", 1, 1.0, True, 1.0), ("obs", 2, 1.0, True, 1.0), ("obs", 3, 1.0, True, 1.0),
        ("obs", 4, 1.0, True, 1.0),
    ]),
    "timeouts-and-ceiling": (["patience:2", "ceiling-patience:3"], [
        ("timeouts", 1, 3, 2), ("timeouts", 2, 1, 2), ("timeouts", 3, 3, 2), ("timeouts", 4, 4, 2),
        ("rollback", 2), ("timeouts", 3, 5, 2), ("timeouts", 4, 5, 2), ("timeouts", 5, 5, 2),
        ("timeouts", 6, 5, 2), ("timeouts", 7, 5, 2),
        ("ceiling", 8, True), ("ceiling", 9, False), ("ceiling", 10, True), ("ceiling", 11, True),
        ("ceiling", 12, True),
    ]),
}


@pytest.mark.parametrize("script", sorted(WATCHDOG_SCRIPTS))
def test_watchdog_decisions_and_journal_match_jax(tmp_path, script):
    config_args, ops = WATCHDOG_SCRIPTS[script]
    timelines, paths = {}, {}
    for label, module, events in PACKAGES:
        wall, mono = _clocks()
        events.install(str(tmp_path / label / "j.jsonl"), run_id="w", wall_clock=wall, mono_clock=mono)
        dog = module.Watchdog(module.GuardianConfig(config_args))
        timeline = []
        for op in ops:
            if op[0] == "obs":
                out = dog.observe(*op[1:])
            elif op[0] == "timeouts":
                out = dog.observe_timeouts(*op[1:])
            elif op[0] == "ceiling":
                out = dog.observe_ceiling(*op[1:])
            else:
                out = dog.note_rollback(op[1])
            timeline.append((op, out, dog.attempts, dog.cooldown_until, dog.healthy, dog.exhausted,
                             dog.recovering, dog.last_reason, dog.unhealthy_streak, dog.healthy_streak))
        timelines[label] = timeline
        paths[label] = events.uninstall()
    assert timelines["port"] == timelines["jax"]
    decisions = [out for _, out, *_ in timelines["port"]]
    assert "rollback" in decisions
    with open(paths["port"], "rb") as ours, open(paths["jax"], "rb") as theirs:
        assert ours.read() == theirs.read()


#: every rung string of JAX tests/test_guardian.py:146-181 (the last two
#: ladders name bucketing)
LADDERS = ["f+1,gar=median,gar=bulyan,quarantine,lr*0.5", "f+0", "f+x", "gar=definitely-not-a-gar",
           "gar=median/no-colon-arg", "lr*0", "lr*1.5", "quarantine=2/0.5", "banana", "",
           "gar=median/inner:x,quarantine=0.8/0.4,lr*0.25", "f+2,gar=krum/m:3,quarantine,lr*1",
           "gar=bucketing/inner:median,quarantine=0.8/0.4,lr*0.25", "gar=bucketing"]


@pytest.mark.parametrize("spec", LADDERS)
def test_ladders_parse_and_apply_like_jax(spec):
    outcomes = {}
    for label, module, _ in PACKAGES:
        def parse_and_apply():
            ladder = module.EscalationLadder(spec)
            overrides, described = module.Overrides(1, "average"), []
            for i in range(len(ladder) + 1):
                rung = ladder.rung(i)
                if rung is not None:
                    overrides = rung.apply(overrides)
                described.append((None if rung is None else rung.describe(), overrides.describe()))
            return len(ladder), ladder.describe(), described

        outcomes[label] = _outcome(parse_and_apply)
    # an unknown rule's text lists the registry of its own package
    registered = " (registered: %s)" % ", ".join(sorted(tgars.itemize()))
    assert outcomes["port"] == tuple(part.replace(JAX_REGISTERED, registered) if isinstance(part, str) else part
                                     for part in outcomes["jax"])
    assert outcomes["port"][0] == ("ok" if spec.startswith(("f+1,", "gar=median/inner", "f+2", "gar=bucketing"))
                                   else "raised")


def test_default_ladder_cumulative_overrides_match_jax():
    described = {}
    for label, module, _ in PACKAGES:
        ladder, overrides = module.EscalationLadder(module.DEFAULT_LADDER), module.Overrides(
            2, "krum", ("m:3",), reputation_decay=None, quarantine_threshold=0.0)
        described[label] = [overrides.describe()]
        for i in range(len(ladder)):
            overrides = ladder.rung(i).apply(overrides)
            described[label].append(overrides.describe())
        assert ladder.rung(99) is None
    assert described["port"] == described["jax"]
    assert described["port"][-1] == "f=3 gar=bulyan lr*0.5 quarantine=0.9/0.5"
    assert tguardian.DEFAULT_LADDER == jguardian.DEFAULT_LADDER
    assert (tguardian.RNG_PERTURB_TAG, tguardian.RESEED_STRIDE) == (jguardian.RNG_PERTURB_TAG,
                                                                    jguardian.RESEED_STRIDE)


@pytest.mark.parametrize("args", [[], ["patience:0"], ["spike:1.0"], ["retries:0"], ["backoff:0.5"],
                                  ["no-such-key:1"], ["recover:0"], ["ceiling-patience:-1"],
                                  ["patience:2", "spike:4", "retries:7", "backoff:1.5", "recover:3"],
                                  ["ladder:gar=median,lr*0.5"], ["ladder:"]])
def test_guardian_config_matches_jax(args):
    keys = ("patience", "spike_factor", "retries", "backoff", "recover_after", "ceiling_patience")
    outcomes = [_outcome(lambda: (lambda c: tuple(getattr(c, k) for k in keys) + (c.ladder.describe(),))(
        module.GuardianConfig(args))) for _, module, _ in PACKAGES]
    assert outcomes[0] == outcomes[1]
    assert tguardian.GuardianConfig.DEFAULTS == jguardian.GuardianConfig.DEFAULTS


# --------------------------------------------------------------------- #
# the runner

EXP = ["--experiment", "mnist", "--experiment-args", "batch-size:16", "hidden:16"]
QUIET = ["--evaluation-delta", "-1", "--evaluation-period", "-1", "--checkpoint-period", "-1", "--prefetch", "0"]
PARITY = EXP + QUIET + [
    "--aggregator", "average", "--nb-workers", "8", "--nb-decl-byz-workers", "2", "--nb-real-byz-workers", "2",
    "--attack", "inf", "--guardian", "--guardian-args", "recover:5", "--checkpoint-delta", "4", "--max-step", "30",
    "--summary-delta", "5", "--learning-rate-args", "initial-rate:0.05",
]


def _summary_events(directory):
    return [json.loads(line) for name in sorted(os.listdir(directory))
            for line in open(os.path.join(directory, name))]


def _run_dir(out, label, argv, main):
    """Run one runner with its journal, metrics file and summaries under
    ``out/label``."""
    where = out / label
    where.mkdir()
    main(argv + ["--checkpoint-dir", str(where / "ckpt"), "--summary-dir", str(where / "sum"),
                 "--journal", str(where / "journal.jsonl"), "--metrics-file", str(where / "m.prom")])
    return where


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The JAX runner (one device) and the port's on the parity argv, each
    with a fresh process-wide registry."""
    out = tmp_path_factory.mktemp("parity")
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmetrics, "REGISTRY", jmetrics.MetricsRegistry())
        mp.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
        _run_dir(out, "jax", PARITY + ["--nb-devices", "1"], jrunner.main)
        _run_dir(out, "port", PARITY + ["--device", "cpu"], lambda argv: results.setdefault("port", runner.main(argv)))
    return out, results["port"]


GUARDIAN_FIELDS = {
    "guardian_rollback": ("from_step", "to_step", "attempt", "restored_snapshot", "reason"),
    "guardian_escalation": ("rung", "attempt", "overrides"),
    "guardian_recovered": ("attempt", "overrides"),
}


def test_guardian_timeline_matches_the_jax_runner(parity):
    out, result = parity
    timelines = {}
    for label in ("jax", "port"):
        events = [e for e in _summary_events(out / label / "sum") if e.get("event") in GUARDIAN_FIELDS]
        timelines[label] = [(e["event"], e["step"]) + tuple(e[k] for k in GUARDIAN_FIELDS[e["event"]])
                            for e in events]
    assert timelines["port"] == timelines["jax"]
    assert [t[0] for t in timelines["port"]] == ["guardian_rollback", "guardian_escalation",
                                                  "guardian_rollback", "guardian_escalation", "guardian_recovered"]
    assert timelines["port"][1][2] == "f+1" and timelines["port"][3][2] == "gar=median"
    assert result["escalations"] == ["f+1", "gar=median"] and len(result["rollbacks"]) == 2
    assert result["recovered"] == [timelines["port"][-1][1]]
    assert sum(result["steps_by_overrides"].values()) == result["steps"] + sum(
        r["from_step"] - r["to_step"] + 1 for r in result["rollbacks"])


def _journal_view(path, module):
    """The journal without times, run ids, paths and the pid."""
    skip = {"t_wall", "t_mono", "run_id", "path", "pid", "schema"}
    view = []
    for record in module.load_journal(path):
        fields = {k: v for k, v in record.items() if k not in skip}
        if "cause" in fields:
            fields["cause"] = fields["cause"]["seq"]
        view.append(fields)
    return view


def test_guardian_journal_matches_the_jax_runner(parity):
    out, _ = parity
    ours = _journal_view(str(out / "port" / "journal.jsonl"), tevents)
    theirs = _journal_view(str(out / "jax" / "journal.jsonl"), jevents)
    assert ours == theirs
    assert [r["type"] for r in ours] == ["run_start", "guardian_rollback_decision", "guardian_rollback",
                                         "guardian_escalation", "guardian_rollback_decision", "guardian_rollback",
                                         "guardian_escalation", "guardian_recovered", "run_end"]


def test_guardian_counters_match_the_jax_runner(parity):
    out, _ = parity
    values = {}
    for label, module in (("jax", jmetrics), ("port", tmetrics)):
        families = module.parse_prometheus(open(out / label / "m.prom").read())
        values[label] = {name: families[name]["samples"][0][2] for name in families if name.startswith("guardian_")}
    assert values["port"] == values["jax"] == {"guardian_rollbacks_total": 2.0, "guardian_escalations_total": 2.0,
                                               "guardian_recoveries_total": 1.0}


def _losses(directory):
    return [e["total_loss"] for e in _summary_events(directory) if "total_loss" in e]


HEALTHY = EXP + QUIET + ["--aggregator", "krum", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
                         "--nb-real-byz-workers", "2", "--attack", "signflip", "--max-step", "12",
                         "--summary-delta", "1", "--checkpoint-delta", "4", "--device", "cpu"]


def test_guardian_on_a_healthy_run_changes_no_loss(tmp_path):
    results = {}
    for label, extra in (("off", []), ("on", ["--guardian"])):
        results[label] = runner.main(HEALTHY + extra + ["--checkpoint-dir", str(tmp_path / label / "ckpt"),
                                                        "--summary-dir", str(tmp_path / label / "sum")])
    assert _losses(tmp_path / "on" / "sum") == _losses(tmp_path / "off" / "sum")
    assert len(_losses(tmp_path / "on" / "sum")) == 12
    assert results["on"]["rollbacks"] == [] and results["on"]["final_loss"] == results["off"]["final_loss"]


def test_guardian_rolls_back_to_the_auto_restored_snapshot(tmp_path, monkeypatch):
    base = EXP + QUIET + ["--nb-workers", "8", "--nb-decl-byz-workers", "2", "--checkpoint-dir",
                          str(tmp_path / "ckpt"), "--device", "cpu"]
    runner.main(base + ["--aggregator", "median", "--max-step", "6"])
    pins, pin = [], Checkpoints.pin
    monkeypatch.setattr(Checkpoints, "pin", lambda self, step: (pins.append(step), pin(self, step))[1])
    result = runner.main(base + [
        "--aggregator", "average", "--nb-real-byz-workers", "2", "--attack", "inf", "--max-step", "20",
        "--guardian", "--guardian-args", "ladder:gar=median", "recover:4", "--checkpoint-delta", "100",
        "--summary-dir", str(tmp_path / "sum"), "--summary-delta", "5"])
    rollbacks = [e for e in _summary_events(tmp_path / "sum") if e.get("event") == "guardian_rollback"]
    assert rollbacks and rollbacks[0]["to_step"] == 6 and rollbacks[0]["restored_snapshot"] is True
    assert result["restored_step"] == 6 and pins[0] == 6 and result["rollbacks"][0]["to_step"] == 6
    assert result["escalations"] == ["gar=median"] and result["recovered"] and np.isfinite(result["final_loss"])


def test_guardian_run_fails_after_bounded_retries(tmp_path):
    with pytest.raises(UserException, match="guardian: run failed"):
        runner.main(EXP + QUIET + [
            "--aggregator", "average", "--nb-workers", "8", "--nb-decl-byz-workers", "2",
            "--nb-real-byz-workers", "2", "--attack", "inf", "--guardian", "--guardian-args", "retries:2",
            "ladder:lr*0.5", "--max-step", "20", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--checkpoint-delta", "5", "--device", "cpu"])


def test_guardian_refusals():
    with pytest.raises(UserException, match="--guardian rolls back to on-disk snapshots; pass --checkpoint-dir"):
        runner.main(["--experiment", "mnist", "--aggregator", "average", "--nb-workers", "4", "--max-step", "2",
                     "--guardian", "--device", "cpu"])
    with pytest.raises(UserException, match="unknown GAR"):  # before anything is built
        runner.main(["--experiment", "mnist", "--aggregator", "average", "--nb-workers", "4", "--max-step", "2",
                     "--guardian", "--guardian-args", "ladder:gar=no-such-rule", "--checkpoint-dir", "unused",
                     "--device", "cpu"])
    assert not os.path.exists("unused")


def test_recovered_run_ends_near_a_healthy_median_run(parity, tmp_path):
    out, _ = parity
    recovered = _losses(out / "port" / "sum")[-1]
    healthy = runner.main(PARITY[:PARITY.index("--guardian")] + ["--max-step", "30", "--device", "cpu",
                                                                  "--summary-dir", str(tmp_path / "sum")]
                          + ["--aggregator", "median"])
    assert np.isfinite(recovered) and recovered <= 1.10 * healthy["final_loss"], (recovered, healthy["final_loss"])


def test_a_rollback_leaves_one_train_state_alive(tmp_path, monkeypatch):
    """After each rollback (f+1, then median) the run holds one TrainState
    at the watchdog's first observation, as before it: no reference to the
    abandoned state (a snapshot's, a restore's) outlives it (the card's
    ``test_a_rebuild_releases_the_old_engines_memory`` counts the bytes)."""
    import gc

    from aggregathor_tpu_torch.core.train_state import TrainState

    seen, observe = {}, tguardian.Watchdog.observe

    def recording(self, step, *args):
        if step == 1 and (self.attempts, step) not in seen:
            gc.collect()
            seen[(self.attempts, step)] = sum(isinstance(o, TrainState) for o in gc.get_objects())
        return observe(self, step, *args)

    monkeypatch.setattr(tguardian.Watchdog, "observe", recording)
    result = runner.main(["--experiment", "mnist", "--experiment-args", "batch-size:16", "--nb-workers", "8",
                          "--nb-decl-byz-workers", "2", "--prefetch", "0", "--evaluation-delta", "-1",
                          "--evaluation-period", "-1", "--checkpoint-period", "-1", "--checkpoint-dir",
                          str(tmp_path / "ckpt"), "--aggregator", "average", "--nb-real-byz-workers", "2", "--attack",
                          "inf", "--max-step", "8", "--guardian", "--guardian-args", "recover:5",
                          "--checkpoint-delta", "100", "--device", "cpu"])
    assert result["escalations"] == ["f+1", "gar=median"]
    assert [seen[(attempt, 1)] for attempt in (0, 1, 2)] == [1, 1, 1]


def test_rollback_under_unroll_rebuilds_the_chunk_pipeline(tmp_path, monkeypatch):
    built, losses = [], {}
    real = datasets.ChunkPipeline

    class Counted(real):
        def __init__(self, *args, **kwargs):
            built.append(args[2])  # the chunks it will produce
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(datasets, "ChunkPipeline", Counted)
    build = RobustEngine.build_multi_step

    def recorded(self, *args, **kwargs):
        multi = build(self, *args, **kwargs)

        def call(state, batches):
            state, many = multi(state, batches)
            into.extend(float(v) for v in many["total_loss"])
            return state, many

        return call

    monkeypatch.setattr(RobustEngine, "build_multi_step", recorded)
    argv = [a for a in PARITY if a not in ("--prefetch", "0")] + ["--unroll", "4", "--device", "cpu"]
    results = {}
    for label, prefetch in (("pipelined", "2"), ("sync", "0")):
        into = losses.setdefault(label, [])
        results[label] = runner.main(argv + ["--prefetch", prefetch, "--checkpoint-dir", str(tmp_path / label)])
    assert built == [7, 7, 7]  # at start and after each of the two rollbacks: 28 steps in chunks of 4
    assert results["pipelined"]["input_pipeline"] == "Counted" and results["sync"]["input_pipeline"] is None
    assert results["pipelined"]["escalations"] == results["sync"]["escalations"] == ["f+1", "gar=median"]
    np.testing.assert_array_equal(losses["pipelined"], losses["sync"])  # NaNs of the abandoned calls included
    after = losses["sync"][16:]  # two abandoned pairs of calls (8 steps each), then the retry's 7 calls
    assert np.all(np.isfinite(after)) and len(after) == 28 and not np.all(np.isfinite(losses["sync"][:16]))


# --------------------------------------------------------------------- #
# the compatibility flags

def _device_of(argv):
    args = runner.build_parser().parse_args(["--experiment", "mnist", "--aggregator", "average",
                                             "--nb-workers", "4"] + argv)
    return runner.resolve_device_flags(args)


@pytest.mark.parametrize("argv, device", [
    ([], "cuda"), (["--platform", "cpu"], "cpu"), (["--platform", "gpu"], "cuda"), (["--platform", "CUDA"], "cuda"),
    (["--use-gpu"], "cuda"), (["--reuse-gpu"], "cuda"), (["--use-tpu", "--use-gpu"], "cuda"),
    (["--device", "cpu"], "cpu"), (["--platform", "cpu", "--use-tpu"], "cpu"),
    (["--platform", "tpu"], "refused"), (["--platform", "cpu,tpu"], "refused"), (["--use-tpu"], "refused"),
    (["--reuse-tpu"], "refused"), (["--use-gpu", "--device", "cpu"], "refused"),
    (["--platform", "gpu", "--device", "cpu"], "refused"),
])
def test_device_flags_map_or_refuse(argv, device):
    if device == "refused":
        with pytest.raises(UserException):
            _device_of(argv)
    else:
        assert _device_of(argv) == device


def test_compat_flags_take_the_jax_defaults():
    argv = ["--experiment", "mnist", "--aggregator", "average", "--nb-workers", "4"]
    ours, theirs = runner.build_parser().parse_args(argv), jrunner.build_parser().parse_args(argv)
    flags = ("platform", "stdout_to", "stderr_to", "use_tpu", "use_gpu", "reuse_tpu", "reuse_gpu", "client",
             "server", "ps_job_name", "ev_job_name", "wk_job_name", "mpi", "no_wait", "backend_timeout",
             "guardian", "guardian_args", "journal", "cause", "journal_max_bytes")
    actions = {a.dest: a for a in runner.build_parser()._actions}
    jax_actions = {a.dest: a for a in jrunner.build_parser()._actions}
    for flag in flags:
        assert getattr(ours, flag) == getattr(theirs, flag), flag
        assert (actions[flag].type, actions[flag].nargs, actions[flag].option_strings) == (
            jax_actions[flag].type, jax_actions[flag].nargs, jax_actions[flag].option_strings), flag


def test_platform_cpu_trains_and_cluster_flags_warn_once(tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setattr(sys, "stdout", sys.stdout)  # restored after the tee
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    result = runner.main(EXP + QUIET + [
        "--aggregator", "average", "--nb-workers", "4", "--max-step", "2", "--platform", "cpu",
        "--client", "grpc://x", "--ps-job-name", "ps", "--MPI", "--no-wait",
        "--stdout-to", str(tmp_path / "out.log"), "--stderr-to", str(tmp_path / "err.log")])
    assert result["device"] == "cpu" and result["steps"] == 2
    warned = [line for line in capsys.readouterr().err.splitlines() if "Compat no-op flags ignored" in line]
    assert len(warned) == 1 and warned[0].endswith("--client --ps-job-name --MPI --no-wait")
    assert "Performance report" in open(tmp_path / "out.log").read()
    assert "Compat no-op flags ignored" in open(tmp_path / "err.log").read()


def test_backend_timeout_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "init", lambda: time.sleep(5))
    began = time.monotonic()
    with pytest.raises(UserException, match="did not initialize within"):
        runner.wait_for_cuda(0.2)
    assert time.monotonic() - began < 2.0

    def broken():
        raise RuntimeError("no driver")

    monkeypatch.setattr(torch.cuda, "init", broken)
    with pytest.raises(RuntimeError, match="no driver"):
        runner.wait_for_cuda(5.0)


def test_cause_flag_stamps_run_start_and_refuses_garbage(tmp_path):
    argv = EXP + QUIET + ["--aggregator", "average", "--nb-workers", "4", "--max-step", "1", "--device", "cpu",
                          "--journal", str(tmp_path / "j.jsonl")]
    runner.main(argv + ["--cause", "sup:r0:12"])
    start = tevents.load_journal(str(tmp_path / "j.jsonl"))[0]
    assert start["type"] == "run_start" and start["cause"] == {"instance": "sup", "run_id": "r0", "seq": 12}
    with pytest.raises(UserException, match="--cause"):
        runner.main(argv + ["--cause", "garbage"])


# --------------------------------------------------------------------- #
# can_access, the three cases of JAX tests/test_utils_access.py

def test_can_access_file_matches_jax(tmp_path):
    f = tmp_path / "x.txt"
    f.write_text("hi")
    for path, kwargs in ((f, {"read": True}), (f, {"read": True, "write": True}),
                         (tmp_path / "missing", {"read": True})):
        assert can_access(str(path), **kwargs) == jax_can_access(str(path), **kwargs)
    assert can_access(str(f), read=True) and not can_access(str(tmp_path / "missing"), read=True)


def test_can_access_dir_recurse_matches_jax(tmp_path):
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "a.txt").write_text("a")
    cases = [{"read": True, "recurse": True}, {"read": True, "recurse": False}, {"write": True, "recurse": True}]
    assert [can_access(str(tmp_path), **c) for c in cases] == [jax_can_access(str(tmp_path), **c) for c in cases]
    if os.geteuid() != 0:  # root bypasses mode bits
        os.chmod(sub / "a.txt", 0o000)
        try:
            assert [can_access(str(tmp_path), **c) for c in cases] == [
                jax_can_access(str(tmp_path), **c) for c in cases]
            assert not can_access(str(tmp_path), read=True, recurse=True)
        finally:
            os.chmod(sub / "a.txt", 0o644)


def test_can_access_write_only_check_matches_jax(tmp_path):
    f = tmp_path / "w.txt"
    f.write_text("")
    assert can_access(str(f), write=True) == jax_can_access(str(f), write=True) is True
