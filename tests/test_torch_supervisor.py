"""The fleet supervisor and the postmortem (``supervisor/``, ``cli/supervise``,
``cli/postmortem``) against the JAX package.

- The pure policy fed the traces of JAX's ``tests/test_supervisor.py``
  (restart backoff, hung and finished instances, flap damping and its
  refund, retune streaks, hysteresis and ladder exhaustion, rollback once a
  verdict) gives JAX's actions, tick for tick.
- The rung grammar, the retune ladders, the fleet spec and the config give
  JAX's results and messages.
- The rollback executor on custody-signed snapshots written by the JAX
  package: the same files discarded and the same journal records.
- One actuator restart of a tiny child process killed with SIGKILL, and
  the supervise CLI's options.
- ``cli.postmortem`` exits 0 on sound journals and 1 on a truncated one,
  its report equal to JAX's.
"""

import json
import os
import signal
import sys
import time

import pytest

from aggregathor_tpu.cli import postmortem as jpostmortem, supervise as jsupervise
from aggregathor_tpu.obs import events as jevents
from aggregathor_tpu.supervisor import (FleetSupervisor as JaxFleetSupervisor, InstanceSpec as JaxInstanceSpec,
                                        Rollback as JaxRollback, SupervisorConfig as JaxConfig,
                                        SupervisorPolicy as JaxPolicy)
from aggregathor_tpu.supervisor import actuator as jactuator
from aggregathor_tpu.supervisor.policy import InstanceObs as JaxObs
from aggregathor_tpu.utils import UserException as JaxUserException
from aggregathor_tpu_torch.cli import postmortem, supervise
from aggregathor_tpu_torch.obs import events as tevents
from aggregathor_tpu_torch.supervisor import (FleetSupervisor, InstanceSpec, Rollback, SupervisorConfig,
                                              SupervisorPolicy)
from aggregathor_tpu_torch.supervisor import actuator
from aggregathor_tpu_torch.supervisor.policy import InstanceObs
from aggregathor_tpu_torch.utils import UserException

from torch_threads import pinned_threads  # noqa: F401  (a fixture: the xdist worker's intra-op pool)


@pytest.fixture(autouse=True)
def _no_journal_leak():
    yield
    jevents.uninstall()
    tevents.uninstall()


# --------------------------------------------------------------------- #
# the pure policy on JAX's traces

DEAD = dict(alive=False, exit_code=-9, up=False, misses=5, age=9.0)
OK = dict(alive=True, exit_code=None, up=True, misses=0, age=0.1)


def _ceiling(seq):
    return ("train", {"type": "deadline_window", "seq": seq, "at_ceiling": True})


def _timeouts(seq):
    return ("train", {"type": "bounded_round", "seq": seq, "timed_out": [1, 3]})


def _regress(judged_at=77.0, verdict="REGRESS"):
    return ("train", {"schema": "aggregathor.obs.slo.v1.verdict", "verdict": verdict, "judged_at": judged_at,
                      "run_id": "r1", "failures": [{"metric": "final_loss"}]})


def _crash_loop():
    return [(0.5 * i, [DEAD], (), ()) for i in range(24)]


#: each trace: (config args, retune ladders, [(now, [obs], events, verdicts), ...])
TRACES = {
    "backoff": (["patience:2", "backoff:2", "max-restarts:9"], None,
                [(t, [DEAD], (), ()) for t in (10.0, 10.5, 11.0, 12.1, 13.0, 16.2)]),
    "hung": ([], None, [(0.0, [dict(OK, up=False, misses=4)], (), ())]),
    "finished": ([], None, [(t, [dict(alive=False, exit_code=0, up=False, misses=0, age=0.1)], (), ())
                            for t in (0.0, 1.0)]),
    "never-scraped": ([], None, [(0.0, [dict(OK, up=None)], (), ()),
                                 (1.0, [dict(alive=False, exit_code=1, up=None, misses=0, age=0.1)], (), ())]),
    "crash-loop": (["patience:1", "backoff:2", "max-restarts:3"], None, _crash_loop()),
    "refund": (["patience:1", "flap-window:30"], None,
               [(0.0, [DEAD], (), ()), (2.0, [OK], (), ()), (40.0, [OK], (), ()), (41.0, [DEAD], (), ())]),
    "retune-streak": (["retune-streak:3"], {"train": ("step-deadline*2", "exchange=int8")},
                      [(0.0, [OK], [_ceiling(0), _ceiling(1)], ()), (1.0, [OK], [_ceiling(2)], ())]),
    "streak-reset": (["retune-streak:3"], {"train": ("step-deadline*2",)},
                     [(0.0, [OK], [_ceiling(0), _ceiling(1),
                                   ("train", {"type": "deadline_window", "seq": 2, "at_ceiling": False}),
                                   _ceiling(3), _ceiling(4)], ()),
                      (1.0, [OK], [_ceiling(5)], ())]),
    "timeout-wave": (["retune-streak:2"], {"train": ("step-deadline*2",)},
                     [(0.0, [OK], [_timeouts(0), _timeouts(1)], ())]),
    "hysteresis": (["retune-streak:2", "retune-cooldown:30"], {"train": ("step-deadline*2", "exchange=int8")},
                   [(0.0, [OK], [_ceiling(0), _ceiling(1)], ()), (5.0, [OK], [_ceiling(2), _ceiling(3)], ()),
                    (6.0, [OK], (), ()), (31.0, [OK], (), ()), (70.0, [OK], [_ceiling(4), _ceiling(5)], ())]),
    "no-ladder": (["retune-streak:1"], None, [(0.0, [OK], [_ceiling(0), _ceiling(1)], ())]),
    "rollback-once": ([], None, [(0.0, [OK], (), [_regress()]), (1.0, [OK], (), [_regress()]),
                                 (2.0, [OK], (), [_regress(judged_at=99.0)]),
                                 (3.0, [OK], (), [_regress(verdict="PASS")])]),
}


def _actions(policy_cls, config_cls, obs_cls, args, retunes, trace):
    policy = policy_cls(config_cls(args), retunes=retunes)
    out = []
    for now, observations, journal_events, verdicts in trace:
        actions = policy.tick(now, [obs_cls("train", "train", o["alive"], o["exit_code"], o["up"], o["misses"],
                                            o["age"]) for o in observations], journal_events, verdicts)
        out.append([(type(action).__name__, action._asdict()) for action in actions])
    return out


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_policy_gives_the_jax_actions(trace):
    args, retunes, ticks = TRACES[trace]
    ours = _actions(SupervisorPolicy, SupervisorConfig, InstanceObs, args, retunes, ticks)
    theirs = _actions(JaxPolicy, JaxConfig, JaxObs, args, retunes, ticks)
    assert ours == theirs
    assert any(ours) == (trace != "no-ladder")


# --------------------------------------------------------------------- #
# the grammar, the ladders, the fleet spec and the config

ARGV = ["prog", "--step-deadline", "1.5", "--exchange", "none"]


def _same(fn_ours, fn_theirs, *args):
    """Both packages' results, or both refusals with the same message."""
    try:
        want = fn_theirs(*args)
    except JaxUserException as exc:
        with pytest.raises(UserException) as mine:
            fn_ours(*args)
        assert str(mine.value) == str(exc)
        return None
    assert fn_ours(*args) == want
    return want


@pytest.mark.parametrize("argv,rung", [
    (ARGV, "step-deadline*2"), (ARGV, "exchange=int8:ef"), (["prog"], "lanes=4"), (["prog"], "step-deadline*2"),
    (ARGV, "step-deadline*fast"), (["prog", "--exchange", "none"], "exchange*2"), (ARGV, "bogus"), (ARGV, "=3"),
])
def test_apply_rung_matches_jax(argv, rung):
    _same(actuator.apply_rung, jactuator.apply_rung, list(argv), rung)


@pytest.mark.parametrize("ladder", [("step-deadline*2", "exchange=int8"), ("bogus",), ("k*fast",), ("=v",)])
def test_validate_retunes_matches_jax(ladder):
    _same(actuator.validate_retunes, jactuator.validate_retunes, {"train": ladder})


@pytest.mark.parametrize("args", [[], ["patience:0"], ["backoff:0.5"], ["max-restarts:0"], ["retune-streak:0"],
                                  ["unknown-knob:1"], ["patience:3", "max-restarts:4", "flap-window:5"]])
def test_config_matches_jax(args):
    _same(lambda a: SupervisorConfig(a).describe(), lambda a: JaxConfig(a).describe(), args)


FLEETS = {
    "relative": {"instances": [
        {"name": "train", "role": "train", "argv": ["{python}", "-m", "x"], "journal": "journal_train.jsonl",
         "verdict": "verdict.json", "checkpoint_dir": "ckpt", "retunes": ["step-deadline*2"]},
        {"name": "router", "role": "router", "argv": ["{python}", "-m", "y"], "url": "127.0.0.1:9000"}]},
    "no-instances": {"fleet": []},
    "duplicate": {"instances": [{"name": "a", "role": "x", "argv": ["p"]}, {"name": "a", "role": "y", "argv": ["p"]}]},
    "unknown-key": {"instances": [{"name": "a", "role": "x", "argv": ["p"], "bogus_key": 1}]},
}


def _spec_view(specs):
    return [{slot: getattr(spec, slot) for slot in ("name", "role", "argv", "url", "journal", "verdict",
                                                    "checkpoint_dir", "retunes", "ready_file")} for spec in specs]


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_load_fleet_spec_matches_jax(fleet, tmp_path):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(FLEETS[fleet]))
    want = _same(lambda p: _spec_view(actuator.load_fleet_spec(p)),
                 lambda p: _spec_view(jactuator.load_fleet_spec(p)), str(path))
    if fleet == "relative":
        assert want[0]["journal"] == str(tmp_path / "journal_train.jsonl")


# --------------------------------------------------------------------- #
# the rollback executor over snapshots the JAX package signed


def _snapshots(directory, secret=b"soak-secret"):
    from aggregathor_tpu.secure import ChainOfCustody

    directory.mkdir()
    custody = ChainOfCustody(secret, run_id="r1")
    for step in (10, 20):
        path = directory / ("model-%d.ckpt" % step)
        data = b"snapshot-bytes-%d" % step
        path.write_bytes(data)
        custody.write(str(path), step, data)


@pytest.mark.parametrize("case", ["verified", "tampered", "no-secret", "unsigned-allowed"])
def test_rollback_executor_matches_jax(case, tmp_path):
    outcome = {}
    for label, events, spec_cls, sup_cls, rollback in (
            ("jax", jevents, JaxInstanceSpec, JaxFleetSupervisor, JaxRollback),
            ("port", tevents, InstanceSpec, FleetSupervisor, Rollback)):
        directory = tmp_path / label
        _snapshots(directory)
        if case == "tampered":
            (directory / "model-10.ckpt").write_bytes(b"swapped-bytes")
        kwargs = {"session_secret": "soak-secret"} if case in ("verified", "tampered") else {}
        if case == "unsigned-allowed":
            kwargs["allow_unsigned"] = True
        journal = str(tmp_path / ("%s.jsonl" % label))
        events.install(journal, run_id="sup")
        supervisor = sup_cls([spec_cls("train", "train", ["{python}", "-c", "pass"], checkpoint_dir=str(directory),
                                       **kwargs)])
        supervisor._execute(rollback(instance="train", verdict_id="judged_at:77.0", reason="sentinel_regress",
                                     evidence={"verdict_id": "judged_at:77.0"}))
        events.uninstall()
        records = [{k: v for k, v in r.items() if k not in ("t_wall", "t_mono")} for r in events.load_journal(journal)]
        for record in records:
            record.get("evidence", {}).pop("error", None)  # names the package's own path
        outcome[label] = sorted(os.listdir(directory)), records
    assert outcome["port"] == outcome["jax"]
    kept = outcome["port"][0]
    assert ("model-20.ckpt" in kept) == (case in ("tampered", "no-secret"))


# --------------------------------------------------------------------- #
# the actuator and the CLIs


def test_actuator_restarts_a_killed_child(tmp_path):
    journal = str(tmp_path / "sup.jsonl")
    tevents.install(journal, run_id="sup")
    spec = InstanceSpec("child", "train", [sys.executable, "-c", "import time; time.sleep(60)"])
    supervisor = FleetSupervisor([spec], config=SupervisorConfig(["patience:0.1"]))
    try:
        supervisor.start()
        first = supervisor.pid_of("child")
        os.kill(first, signal.SIGKILL)
        deadline = time.monotonic() + 20.0
        while supervisor.restarts_of("child") == 0 and time.monotonic() < deadline:
            supervisor.tick()
            time.sleep(0.05)
        assert supervisor.restarts_of("child") == 1
        second = supervisor.pid_of("child")
        assert second not in (None, first)
    finally:
        supervisor.stop()
        tevents.uninstall()
    (restart,) = [r for r in tevents.load_journal(journal) if r["type"] == "supervisor_restart"]
    assert restart["instance"] == "child" and restart["reason"] == "dead"


def _option_view(parser):
    return sorted((action.option_strings[0], action.default, action.nargs) for action in parser._actions
                  if action.option_strings and action.option_strings[0] != "-h")


def test_the_cli_options_and_defaults_are_jax_s():
    assert _option_view(supervise.build_parser()) == _option_view(jsupervise.build_parser())
    assert _option_view(postmortem.build_parser()) == _option_view(jpostmortem.build_parser())


def _story_journals(tmp_path):
    """A supervisor's restart and the child run it spawned, the child's
    run_start citing the restart: one closed causal chain."""
    sup, child = str(tmp_path / "supervisor.jsonl"), str(tmp_path / "train.jsonl")
    tevents.install(sup, run_id="sup-run")
    tevents.emit("run_start", role="supervisor", cause=None)
    restart = tevents.emit("supervisor_restart", instance="train", attempt=0, backoff_s=1.0, reason="dead",
                           evidence={"exit_code": -9}, cause=None)
    tevents.emit("run_end", role="supervisor")
    tevents.uninstall()
    tevents.install(child, run_id="train-run")
    tevents.emit("run_start", role="train", cause=tevents.cause_of(restart, "supervisor"))
    tevents.emit("run_end", step=3, diverged=False)
    tevents.uninstall()
    return ["supervisor=" + sup, "train=" + child], child


def _postmortem(main, journals, report):
    code = main(sum((["--journal", j] for j in journals), []) + ["--report", str(report), "--quiet"])
    return code, json.load(open(report))


def test_postmortem_matches_jax_on_sound_and_truncated_journals(tmp_path):
    journals, child = _story_journals(tmp_path)
    ours = _postmortem(postmortem.main, journals, tmp_path / "ours.json")
    theirs = _postmortem(jpostmortem.main, journals, tmp_path / "theirs.json")
    assert ours == theirs and ours[0] == 0 and ours[1]["verdict"] == "PASS"
    with open(child, "rb+") as fd:
        size = os.path.getsize(child)
        fd.truncate(size - 7)  # torn mid-line
    ours = _postmortem(postmortem.main, journals, tmp_path / "ours.json")
    theirs = _postmortem(jpostmortem.main, journals, tmp_path / "theirs.json")
    assert ours == theirs and ours[0] == 1 and ours[1]["verdict"] == "FAIL"
