"""Fleet supervision actuator: the impure half of the supervisor.

A copy of ``aggregathor_tpu/supervisor/actuator.py`` over the port's
``obs/fleet``, ``obs/events``, ``obs/checkpoint`` and ``secure`` (it
imports no JAX; the fleet it spawns is whatever argvs the spec names).

``FleetSupervisor`` owns the fleet's processes.  It spawns every
:class:`InstanceSpec`, scrapes them through the ``FleetCollector``,
tails their journals with the incremental cursor (``obs/events.py
tail_journal`` — no re-reading whole files every tick), watches their
sentinel verdict files (obs/slo.py), and each :meth:`tick` feeds all of
it to the pure :class:`~.policy.SupervisorPolicy` and EXECUTES the
returned actions:

- **Restart**: SIGKILL the remains (a hung process survives its down
  judgment), respawn the same argv, wait for the ready-file handshake.
- **Quarantine**: kill and DO NOT respawn; the spec is marked so even a
  supervisor restart will not resurrect the crash-looper.
- **Retune**: rewrite the instance's argv through its rung
  (:func:`apply_rung` — ``KEY=VALUE`` sets a flag, ``KEY*X`` scales a
  numeric one), then SIGTERM -> wait -> respawn: the Overrides
  rebuild discipline at fleet level — never mutate a running instance,
  rebuild its config and pay one restart on the rare path.
- **Rollback**: custody-verify the restore target (secure/custody.py,
  fail-closed without a session secret unless ``allow_unsigned``), then
  ``Checkpoints.discard_after`` the regressed tail so every later
  restore — auto-restore, serve followers — lands on the
  rolled-back-to snapshot.  Serving replicas only ever swap NEWER
  steps in (serve/weights.py), so the rollback is never client-visible.

Every executed action is one typed journal event
(``supervisor_restart/quarantine/retune/rollback/observe``) carrying the
policy's triggering evidence — the causal chain from symptom to action
replays from the merged fleet journal.

The causal plane: action events are emitted
BEFORE the respawn so the freshly minted ``(run_id, seq)`` can be handed
to the child as ``--cause INSTANCE:RUN_ID:SEQ`` (specs opt in with
``cause_flag``); the child's ``run_start`` then cites the exact
``supervisor_restart``/``supervisor_retune`` that spawned it, and
``cli.postmortem`` replays the cross-process chain from the journals
alone.  Retune events additionally cite the LAST streak-forming journal
record of the retuned instance (the policy's evidence refs plus the
tailed stream's current ``run_id``).
"""

import json
import os
import signal
import subprocess
import sys
import time

from ..obs import events
from ..obs.fleet import FleetCollector
from ..utils import UserException, info, warning
from .policy import (
    InstanceObs, Observe, Quarantine, Restart, Retune, Rollback,
    SupervisorConfig, SupervisorPolicy,
)


def apply_rung(argv, rung):
    """Rewrite an argv through one retune rung; returns the NEW argv.

    Grammar: ``KEY=VALUE`` sets ``--KEY VALUE`` (replacing the existing
    occurrence, appending when absent); ``KEY*X`` multiplies the existing
    numeric value of ``--KEY`` by X (the flag must already be present).
    """
    argv = list(argv)
    if "*" in rung and "=" not in rung:
        key, factor_text = rung.split("*", 1)
        flag = "--" + key
        try:
            factor = float(factor_text)
        except ValueError:
            raise UserException(
                "Retune rung %r: factor %r is not a number" % (rung, factor_text))
        try:
            at = argv.index(flag)
        except ValueError:
            raise UserException(
                "Retune rung %r scales %s but the instance argv does not "
                "carry it — scaling rungs need an explicit baseline"
                % (rung, flag))
        if at + 1 >= len(argv):
            raise UserException(
                "Retune rung %r: %s is the last argv token (no value)"
                % (rung, flag))
        try:
            current = float(argv[at + 1])
        except ValueError:
            raise UserException(
                "Retune rung %r: current %s value %r is not numeric"
                % (rung, flag, argv[at + 1]))
        scaled = current * factor
        argv[at + 1] = ("%d" % int(scaled)
                        if float(int(scaled)) == scaled else repr(scaled))
        return argv
    if "=" in rung:
        key, value = rung.split("=", 1)
        if not key:
            raise UserException("Retune rung %r has an empty key" % (rung,))
        flag = "--" + key
        try:
            at = argv.index(flag)
        except ValueError:
            argv.extend([flag, value])
            return argv
        if at + 1 >= len(argv):
            raise UserException(
                "Retune rung %r: %s is the last argv token (no value)"
                % (rung, flag))
        argv[at + 1] = value
        return argv
    raise UserException(
        "Retune rung %r: expected KEY=VALUE or KEY*X" % (rung,))


def validate_retunes(retunes):
    """Shape-check a {instance: [rung, ...]} ladder map at startup — a
    malformed rung must fail the fleet launch, not a 3 a.m. retune."""
    for name, rungs in (retunes or {}).items():
        for rung in rungs:
            if "*" in rung and "=" not in rung:
                key, _, factor = rung.partition("*")
                try:
                    float(factor)
                except ValueError:
                    raise UserException(
                        "Retune ladder for %r: rung %r factor is not a "
                        "number" % (name, rung))
                if not key:
                    raise UserException(
                        "Retune ladder for %r: rung %r has an empty key"
                        % (name, rung))
            elif "=" in rung:
                if not rung.partition("=")[0]:
                    raise UserException(
                        "Retune ladder for %r: rung %r has an empty key"
                        % (name, rung))
            else:
                raise UserException(
                    "Retune ladder for %r: rung %r is neither KEY=VALUE "
                    "nor KEY*X" % (name, rung))


class InstanceSpec:
    """One supervised fleet member (parsed from the ``--fleet`` JSON).

    ``argv`` is the full command (a leading ``"{python}"`` token resolves
    to ``sys.executable``); ``url`` is the static ``host:port`` to scrape
    (or None to resolve it from ``ready_file`` after spawn, or to skip
    scraping entirely); ``journal`` is the instance's journal file to
    tail; ``verdict`` the sentinel verdict JSON the instance writes
    (``--slo-verdict``); ``checkpoint_dir``/``session_secret`` arm the
    rollback path; ``cause_flag`` opts the instance into causal-plane
    argv injection — action-triggered respawns then carry
    ``--cause INSTANCE:RUN_ID:SEQ`` citing the spawning action event
    (opt-in because arbitrary argvs — crash-looper one-liners, non-CLI
    processes — must not receive flags they never declared)."""

    __slots__ = ("name", "role", "argv", "env", "cwd", "url", "ready_file",
                 "ready_timeout", "journal", "verdict", "checkpoint_dir",
                 "checkpoint_base_name", "session_secret", "allow_unsigned",
                 "retunes", "log", "stop_timeout", "cause_flag")

    def __init__(self, name, role, argv, env=None, cwd=None, url=None,
                 ready_file=None, ready_timeout=180.0, journal=None,
                 verdict=None, checkpoint_dir=None,
                 checkpoint_base_name="model", session_secret=None,
                 allow_unsigned=False, retunes=(), log=None,
                 stop_timeout=20.0, cause_flag=False):
        self.name = str(name)
        self.role = str(role)
        self.argv = [sys.executable if a == "{python}" else str(a)
                     for a in argv]
        self.env = dict(env) if env else None
        self.cwd = cwd
        self.url = url
        self.ready_file = ready_file
        self.ready_timeout = float(ready_timeout)
        self.journal = journal
        self.verdict = verdict
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_base_name = checkpoint_base_name
        self.session_secret = session_secret
        self.allow_unsigned = bool(allow_unsigned)
        self.retunes = tuple(retunes)
        self.log = log
        self.stop_timeout = float(stop_timeout)
        self.cause_flag = bool(cause_flag)
        if not self.argv:
            raise UserException("Instance %r has an empty argv" % (self.name,))


def load_fleet_spec(path):
    """Parse the ``--fleet`` JSON file -> list of :class:`InstanceSpec`.

    Shape: ``{"instances": [{"name": ..., "role": ..., "argv": [...],
    ...InstanceSpec keywords...}, ...]}``.  Relative paths in the spec are
    taken relative to the spec file's directory, so a fleet directory is
    relocatable."""
    with open(path) as fd:
        doc = json.load(fd)
    if not isinstance(doc, dict) or not isinstance(doc.get("instances"), list):
        raise UserException(
            "Fleet spec %r wants {\"instances\": [...]} at top level" % (path,))
    base = os.path.dirname(os.path.abspath(path))

    def _resolve(value):
        if value is None:
            return None
        return value if os.path.isabs(value) else os.path.join(base, value)

    specs = []
    for entry in doc["instances"]:
        if not isinstance(entry, dict):
            raise UserException("Fleet spec instance %r is not an object" % (entry,))
        kwargs = dict(entry)
        for key in ("ready_file", "journal", "verdict", "checkpoint_dir",
                    "log", "cwd"):
            if key in kwargs:
                kwargs[key] = _resolve(kwargs[key])
        try:
            specs.append(InstanceSpec(**kwargs))
        except TypeError as exc:
            raise UserException(
                "Fleet spec instance %r: %s" % (entry.get("name"), exc))
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise UserException("Fleet spec %r has duplicate instance names" % (path,))
    return specs


class _Managed:
    """Runtime state of one supervised instance (actuator-internal)."""

    __slots__ = ("spec", "proc", "url", "cursor", "verdict_stamp",
                 "quarantined", "spawned_at", "restarts", "last_run_id")

    def __init__(self, spec):
        self.spec = spec
        self.proc = None
        self.url = spec.url
        self.cursor = None            # tail_journal position
        self.verdict_stamp = None     # (mtime_ns, size) of the verdict file
        self.quarantined = False
        self.spawned_at = None
        self.restarts = 0
        self.last_run_id = None       # run_id of the last tailed record


class FleetSupervisor:
    """Spawn, watch and steer a fleet of train/serve/router instances."""

    def __init__(self, specs, config=None, retunes=None, down_after=3,
                 scrape_timeout=2.0, clock=None, instance_name="supervisor"):
        self.config = config if config is not None else SupervisorConfig()
        #: this supervisor's name in cross-journal cause references —
        #: children spawned by an action cite (instance_name, run_id, seq)
        self.instance_name = str(instance_name)
        self.specs = list(specs)
        ladder_map = dict(retunes or {})
        for spec in self.specs:
            if spec.retunes:
                ladder_map.setdefault(spec.name, tuple(spec.retunes))
        validate_retunes(ladder_map)
        self.policy = SupervisorPolicy(self.config, retunes=ladder_map)
        self.down_after = int(down_after)
        self.scrape_timeout = float(scrape_timeout)
        self.clock = clock if clock is not None else time.monotonic
        self._managed = {spec.name: _Managed(spec) for spec in self.specs}
        self._collector = None
        self._collector_urls = {}

    # ------------------------------------------------------------------ #
    # process lifecycle

    def _spawn(self, managed, wait_ready=True, cause_record=None):
        spec = managed.spec
        argv = spec.argv
        if cause_record is not None and spec.cause_flag:
            # Causal-plane injection: the action event that decided this
            # spawn was emitted first, so its (run_id, seq) exists to be
            # cited.  apply_rung's KEY=VALUE grammar sets-or-replaces
            # ``--cause`` on a COPY — spec.argv is never mutated, the
            # injection is per-spawn.
            token = events.format_cause(
                events.cause_of(cause_record, self.instance_name))
            argv = apply_rung(list(spec.argv), "cause=%s" % token)
        if spec.ready_file and os.path.exists(spec.ready_file):
            os.remove(spec.ready_file)   # a stale handshake is a lie
        log_fd = None
        if spec.log:
            os.makedirs(os.path.dirname(spec.log) or ".", exist_ok=True)
            log_fd = open(spec.log, "a")
        env = None
        if spec.env:
            env = dict(os.environ)
            env.update({str(k): str(v) for k, v in spec.env.items()})
        try:
            managed.proc = subprocess.Popen(
                argv, cwd=spec.cwd, env=env,
                stdout=log_fd if log_fd else subprocess.DEVNULL,
                stderr=subprocess.STDOUT if log_fd else subprocess.DEVNULL,
            )
        finally:
            if log_fd:
                log_fd.close()
        managed.spawned_at = self.clock()
        if spec.ready_file and wait_ready:
            deadline = time.monotonic() + spec.ready_timeout
            while time.monotonic() < deadline:
                if os.path.exists(spec.ready_file):
                    break
                if managed.proc.poll() is not None:
                    break               # died during startup: next tick sees it
                time.sleep(0.05)
            if os.path.exists(spec.ready_file):
                # serve/router write "host port pid"; the trainer's live
                # exporter writes "host port" — the pid is optional here
                # (process identity comes from Popen, not the handshake)
                fields = open(spec.ready_file).read().split()
                managed.url = "%s:%s" % (fields[0], fields[1])
        return managed.proc

    def _kill(self, managed, sig=signal.SIGKILL, wait=True):
        proc = managed.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(sig)
        except OSError:
            return
        if not wait:
            return
        try:
            proc.wait(timeout=managed.spec.stop_timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=managed.spec.stop_timeout)

    def start(self):
        """Spawn the whole fleet (ready-file handshakes respected)."""
        for managed in self._managed.values():
            self._spawn(managed)
        self._rebuild_collector()

    def stop(self, sig=signal.SIGTERM):
        """Stop every live instance (graceful by default: serve drains)."""
        for managed in self._managed.values():
            proc = managed.proc
            if proc is None or proc.poll() is not None:
                continue
            try:
                proc.send_signal(sig)
            except OSError:
                continue
        for managed in self._managed.values():
            proc = managed.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=managed.spec.stop_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()

    def pid_of(self, name):
        """The live pid of an instance (chaos drivers SIGKILL through
        this), or None."""
        managed = self._managed[name]
        if managed.proc is None or managed.proc.poll() is not None:
            return None
        return managed.proc.pid

    def url_of(self, name):
        return self._managed[name].url

    def restarts_of(self, name):
        return self._managed[name].restarts

    def up_of(self, name):
        """The collector's live judgment of an instance (True/False), or
        None when it exposes no scrape URL or was never polled — the soak
        driver's recovery probe."""
        if self._collector is None or name not in self._collector_urls:
            return None
        return self._collector.instance_up(name)

    def is_quarantined(self, name):
        return self._managed[name].quarantined

    # ------------------------------------------------------------------ #
    # sensing

    def _rebuild_collector(self):
        urls = {name: managed.url
                for name, managed in self._managed.items()
                if managed.url and not managed.quarantined}
        if urls != self._collector_urls:
            self._collector_urls = dict(urls)
            self._collector = FleetCollector(
                urls, down_after=self.down_after,
                timeout=self.scrape_timeout,
            ) if urls else None

    def _observations(self, scraped):
        out = []
        for name, managed in self._managed.items():
            proc = managed.proc
            alive = proc is not None and proc.poll() is None
            exit_code = None if alive or proc is None else proc.returncode
            inst = (scraped or {}).get(name)
            up = None
            misses = 0
            age = None
            if inst is not None:
                misses = inst.get("consecutive_misses", 0)
                age = inst.get("last_scrape_age_seconds")
                if inst.get("up"):
                    up = True
                elif inst.get("stale"):
                    up = False        # was seen, now judged down
            out.append(InstanceObs(
                name=name, role=managed.spec.role, alive=alive,
                exit_code=exit_code, up=up, consecutive_misses=misses,
                last_scrape_age=age,
            ))
        return out

    def _tail_journals(self):
        new = []
        for name, managed in self._managed.items():
            path = managed.spec.journal
            if not path:
                continue
            try:
                records, managed.cursor = events.tail_journal(
                    path, managed.cursor)
            except ValueError as exc:
                warning("Supervisor: journal tail of %r failed: %s" % (name, exc))
                continue
            if records:
                # remember the stream's current run_id so evidence seqs
                # (policy streak refs) can be completed into full cause
                # references (instance, run_id, seq)
                managed.last_run_id = records[-1].get("run_id")
            new.extend((name, record) for record in records)
        return new

    def _fresh_verdicts(self):
        fresh = []
        for name, managed in self._managed.items():
            path = managed.spec.verdict
            if not path:
                continue
            try:
                stat = os.stat(path)
            except OSError:
                continue
            stamp = (stat.st_mtime_ns, stat.st_size)
            if stamp == managed.verdict_stamp:
                continue
            try:
                with open(path) as fd:
                    doc = json.load(fd)
            except (OSError, ValueError):
                continue              # mid-write: re-read next tick
            managed.verdict_stamp = stamp
            fresh.append((name, doc))
        return fresh

    # ------------------------------------------------------------------ #
    # the loop

    def tick(self):
        """One sense -> decide -> act round.  Returns the executed
        actions (the soak driver records their timing)."""
        scraped = None
        self._rebuild_collector()
        if self._collector is not None:
            self._collector.poll_once()
            scraped = self._collector.status_payload()["instances"]
        observations = self._observations(scraped)
        journal_events = self._tail_journals()
        verdicts = self._fresh_verdicts()
        actions = self.policy.tick(
            self.clock(), observations, journal_events, verdicts)
        for action in actions:
            self._execute(action)
        return actions

    def run(self, tick_interval=1.0, should_stop=None, max_ticks=None):
        """The supervision loop (``cli.supervise``).  ``should_stop`` is a
        callable polled between ticks; ``max_ticks`` bounds the loop for
        smokes."""
        ticks = 0
        while should_stop is None or not should_stop():
            self.tick()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
            time.sleep(tick_interval)
        return ticks

    # ------------------------------------------------------------------ #
    # acting

    def _execute(self, action):
        if isinstance(action, Restart):
            self._execute_restart(action)
        elif isinstance(action, Quarantine):
            self._execute_quarantine(action)
        elif isinstance(action, Retune):
            self._execute_retune(action)
        elif isinstance(action, Rollback):
            self._execute_rollback(action)
        elif isinstance(action, Observe):
            events.emit("supervisor_observe", instance=action.instance,
                        reason=action.reason, evidence=action.evidence,
                        cause=self._evidence_cause(action))
        else:
            raise UserException("Unknown supervisor action %r" % (action,))

    def _evidence_cause(self, action):
        """Complete the policy's evidence refs into a full cause reference.

        Retune-path evidence carries ``events: [{"type", "seq"}, ...]`` —
        seqs of the streak-forming records in the INSTANCE's journal.  The
        policy is pure and never sees run_ids, so the actuator supplies
        the tailed stream's current one; the last streak event (the one
        that tipped the threshold) becomes the cause.  Liveness/rollback
        evidence has no journal refs — those actions carry no cause (the
        sentinel verdict is a file, cited via ``evidence.verdict_id``)."""
        evidence = getattr(action, "evidence", None) or {}
        refs = evidence.get("events")
        if not refs:
            return None
        managed = self._managed.get(action.instance)
        if managed is None or managed.last_run_id is None:
            return None
        seq = refs[-1].get("seq")
        if seq is None:
            return None
        return {"instance": action.instance,
                "run_id": managed.last_run_id, "seq": seq}

    def _execute_restart(self, action):
        managed = self._managed[action.instance]
        self._kill(managed)           # a hung process survives its judgment
        # Emit BEFORE the respawn: the child cites this record's
        # (run_id, seq) through the injected ``--cause`` flag, so the
        # reference must exist before the child's run_start is minted.
        record = events.emit(
            "supervisor_restart", instance=action.instance,
            reason=action.reason, attempt=action.attempt,
            backoff_s=action.backoff_s, evidence=action.evidence,
            cause=self._evidence_cause(action))
        self._spawn(managed, cause_record=record)
        managed.restarts += 1
        info("Supervisor: restarted %r (%s, attempt %d, next grace %.3gs)"
             % (action.instance, action.reason, action.attempt,
                action.backoff_s))

    def _execute_quarantine(self, action):
        managed = self._managed[action.instance]
        self._kill(managed)
        managed.quarantined = True
        warning("Supervisor: QUARANTINED crash-looping instance %r after "
                "%d restarts" % (action.instance, action.attempts))
        events.emit("supervisor_quarantine", instance=action.instance,
                    reason=action.reason, attempts=action.attempts,
                    evidence=action.evidence,
                    cause=self._evidence_cause(action))

    def _execute_retune(self, action):
        managed = self._managed[action.instance]
        spec = managed.spec
        old_argv = list(spec.argv)
        spec.argv = apply_rung(spec.argv, action.rung)
        self._kill(managed, sig=signal.SIGTERM)   # graceful: drains apply
        # Emit before the respawn (see _execute_restart); the retune cites
        # the streak record that tipped the threshold as its own cause.
        record = events.emit(
            "supervisor_retune", instance=action.instance,
            rung=action.rung, rung_index=action.rung_index,
            reason=action.reason,
            argv_diff={"before": old_argv, "after": list(spec.argv)},
            evidence=action.evidence, cause=self._evidence_cause(action))
        self._spawn(managed, cause_record=record)
        managed.restarts += 1
        info("Supervisor: retuned %r rung %d (%s) — argv rebuilt, "
             "instance restarted" % (action.instance, action.rung_index,
                                     action.rung))

    def _execute_rollback(self, action):
        from ..obs.checkpoint import Checkpoints

        managed = self._managed[action.instance]
        spec = managed.spec
        if not spec.checkpoint_dir:
            events.emit("supervisor_observe", instance=action.instance,
                        reason="rollback_unavailable",
                        evidence=dict(action.evidence,
                                      detail="no checkpoint_dir in spec"),
                        cause=None)
            return
        checkpoints = Checkpoints(spec.checkpoint_dir,
                                  base_name=spec.checkpoint_base_name)
        steps = checkpoints.steps()
        if len(steps) < 2:
            events.emit("supervisor_observe", instance=action.instance,
                        reason="rollback_unavailable",
                        evidence=dict(action.evidence,
                                      detail="fewer than 2 snapshots",
                                      steps=steps),
                        cause=None)
            return
        restore_step = steps[-2]
        verified = False
        path = os.path.join(
            spec.checkpoint_dir,
            "%s-%d.ckpt" % (spec.checkpoint_base_name, restore_step))
        if spec.session_secret:
            from ..secure import ChainOfCustody

            custody = ChainOfCustody(spec.session_secret.encode(),
                                     allow_unsigned=spec.allow_unsigned)
            try:
                with open(path, "rb") as fd:
                    data = fd.read()
                verified = custody.verify(path, restore_step, data)
            except (OSError, UserException) as exc:
                warning("Supervisor: rollback of %r REFUSED — custody "
                        "verification failed: %s" % (action.instance, exc))
                events.emit("supervisor_observe", instance=action.instance,
                            reason="rollback_custody_refused",
                            evidence=dict(action.evidence, error=str(exc)),
                            cause=None)
                return
        elif not spec.allow_unsigned:
            warning("Supervisor: rollback of %r REFUSED — no session "
                    "secret and allow_unsigned is off (fail-closed, the "
                    "serve restore discipline)" % (action.instance,))
            events.emit("supervisor_observe", instance=action.instance,
                        reason="rollback_custody_refused",
                        evidence=dict(action.evidence,
                                      detail="unsigned and not allowed"),
                        cause=None)
            return
        discarded = checkpoints.discard_after(restore_step)
        stopped = False
        if managed.proc is not None and managed.proc.poll() is None:
            # A live instance is gracefully STOPPED onto the restored
            # timeline — its next checkpoint would otherwise re-extend the
            # discarded tail.  It is deliberately NOT respawned: an
            # auto-retry of the run that just regressed would re-judge,
            # re-REGRESS and loop (each re-run mints a fresh verdict
            # identity, so the policy's rollback-once key cannot damp it).
            # Resuming from the restored snapshot is the liveness policy's
            # or the operator's call.
            self._kill(managed, sig=signal.SIGTERM)
            stopped = True
        info("Supervisor: rolled %r back to step %d (discarded %r, "
             "custody_verified=%r)" % (action.instance, restore_step,
                                       discarded, verified))
        # cause=None deliberately: the trigger is a sentinel VERDICT FILE,
        # not a journal event — the link to it is ``evidence.verdict_id``
        # (the postmortem resolves verdict->rollback chains through it).
        events.emit("supervisor_rollback", instance=action.instance,
                    restore_step=restore_step, discarded_steps=discarded,
                    custody_verified=verified, stopped=stopped,
                    reason=action.reason, evidence=action.evidence,
                    cause=None)
