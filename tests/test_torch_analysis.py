"""The port's graftcheck (``aggregathor_tpu_torch/analysis``) against its
own package and against the JAX package's gate where the two meet.

Mirrors ``tests/test_analysis.py`` where a test applies to torch:

- one seeded-violation fixture per checker, tripping only its own checker,
  and one per code (RT001-RT003, PK001-PK003, CC001, CC002, EV001, EV002),
  tripping only its own code;
- the baseline lifecycle (BL001 stale, BL002 empty), the report schema and
  the CLI at ``--device cpu`` (without it the sweep raises on a machine
  with no GPU);
- the GAR contract sweep: its spec list equal to JAX's ``default_specs()``,
  each spec's feasible (n, f) equal to JAX's ``_feasible`` (parse only, no
  JAX compile), a lying rule convicted, and the clean sweep on the CPU;
- the whole port clean with its shipped baseline.

The package scan and the CPU sweep are cached per process
(``core._MODULE_CACHE``, ``gar_contract._check_cached``), so the tests
pay for each once.
"""

import json
import textwrap

import pytest
import torch
from torch_threads import pinned_threads  # noqa: F401

from aggregathor_tpu.analysis import gar_contract as jax_gar_contract
from aggregathor_tpu_torch import gars
from aggregathor_tpu_torch.analysis import (
    CHECKERS,
    active_codes,
    baseline as baseline_mod,
    concurrency,
    core,
    gar_contract,
    prng,
    report as report_mod,
    retrace,
    run_checkers,
)
from aggregathor_tpu_torch.analysis.__main__ import main
from aggregathor_tpu_torch.utils import UserException

AST_CHECKERS = {name: mod for name, mod in CHECKERS.items() if name != "gar-contract"}


def snippet_module(tmp_path, name, source):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return core.Module(str(tmp_path), name, textwrap.dedent(source))


def run_ast_checkers(module):
    """(checker name -> findings) for one snippet across ALL AST checkers."""
    return {name: mod.check([module]) for name, mod in AST_CHECKERS.items()}


def only(results, checker):
    """Every other checker found nothing."""
    for name, findings in results.items():
        if name != checker:
            assert findings == [], (name, findings)


# --------------------------------------------------------------------- #
# seeded violations: one per checker, tripping exactly that checker


RETRACE_SNIPPET = """
    import torch
    from torch.func import vmap

    from aggregathor_tpu_torch.ops import build


    def register_many(fns):
        ops = []
        for fn in fns:
            ops.append(torch.library.custom_op("ns::op", fn, mutates_args=()))  # RT001: per iteration
        return ops


    def hot(x):
        lib = build.library("distances")   # RT001: a build inside a transformed scope
        y = x.item()                       # RT002: host read of the vmapped x
        if x.sum() > 0:                    # RT003: Python branch on the vmapped x
            y = y + 1.0
        return x * y, lib


    fast = vmap(hot)
"""

PRNG_SNIPPET = """
    import numpy as np
    import torch

    from aggregathor_tpu_torch.parallel.engine import stream_generator


    def twin_streams(seed, step, w):
        a = stream_generator(seed, step, w, 1, "cpu")
        b = stream_generator(seed, step, w, 1, "cpu")      # PK001: the same stream twice
        return torch.rand(2, generator=a) + torch.rand(2, generator=b)


    def minted_and_dropped(seed):
        unused = torch.Generator("cpu").manual_seed(seed)  # PK002: never read
        return seed


    def keyless(n):
        noise = torch.randn(n)                              # PK003: no generator=
        return noise + torch.as_tensor(np.random.normal(size=n))  # PK003: numpy's global stream


    ALPHA_TAG = 9
    BETA_TAG = 9                                            # PK001: two tags, one stream
"""

CONCURRENCY_SNIPPET = """
    import threading


    class Worker:
        def __init__(self):
            self.count = 0
            self.note = None
            self._lock = threading.Lock()
            self._thread = threading.Thread(target=self._run, daemon=True)

        def _run(self):
            self.note = "hot"                 # CC001: unlocked shared write
            self._helper()
            with self._lock:
                self.count += 1               # locked: fine

        def _helper(self):
            self.count += 1                   # CC001: reachable, unlocked
"""

COLLECTIVE_SNIPPET = """
    import threading

    import torch.distributed as dist
    from torch.distributed import broadcast


    class Unit:
        def __init__(self, group):
            self.group = group
            self._thread = threading.Thread(target=self._run, daemon=True)

        def _run(self, rows):
            dist.all_reduce(rows, group=self.group)   # the unit's own group: fine
            self._gather(rows)

        def _gather(self, rows):
            dist.all_gather([rows, rows], rows)       # CC002: the default group on a thread
            broadcast(rows, 0)                        # CC002: the same, imported bare


    def on_the_main_thread(rows):
        dist.all_reduce(rows)                         # not thread-reachable: fine
"""


def test_retrace_fixture_trips_only_retrace(tmp_path):
    module = snippet_module(tmp_path, "seeded_retrace.py", RETRACE_SNIPPET)
    results = run_ast_checkers(module)
    found = sorted((f.code, f.scope, f.symbol) for f in results["retrace"])
    assert found == [("RT001", "hot", "build.library.traced"), ("RT001", "register_many", "torch.library.custom_op"),
                     ("RT002", "hot", "item"), ("RT003", "hot", "x")], found
    only(results, "retrace")


def test_prng_fixture_trips_only_prng(tmp_path):
    module = snippet_module(tmp_path, "seeded_prng.py", PRNG_SNIPPET)
    results = run_ast_checkers(module)
    found = sorted((f.code, f.scope, f.symbol) for f in results["prng"])
    assert found == [("PK001", "<tags>", "ALPHA_TAG=BETA_TAG"), ("PK001", "twin_streams", "stream_generator"),
                     ("PK002", "minted_and_dropped", "unused"), ("PK003", "keyless", "np.random.normal"),
                     ("PK003", "keyless", "torch.randn")], found
    only(results, "prng")


def test_concurrency_fixture_trips_only_concurrency(tmp_path):
    module = snippet_module(tmp_path, "seeded_concurrency.py", CONCURRENCY_SNIPPET)
    results = run_ast_checkers(module)
    assert sorted({f.code for f in results["concurrency"]}) == ["CC001"]
    # both the direct write and the transitively-reachable helper's write
    assert {f.scope for f in results["concurrency"]} == {"Worker._run", "Worker._helper"}
    only(results, "concurrency")


def test_collective_fixture_trips_only_cc002(tmp_path):
    """Trap ba's rule: a collective on a thread-reachable path names its
    group; the main thread's default-group call and the unit's own group
    pass."""
    module = snippet_module(tmp_path, "seeded_collective.py", COLLECTIVE_SNIPPET)
    results = run_ast_checkers(module)
    found = sorted((f.code, f.scope, f.symbol) for f in results["concurrency"])
    assert found == [("CC002", "Unit._gather", "all_gather"), ("CC002", "Unit._gather", "broadcast")], found
    only(results, "concurrency")


#: one snippet a code, each of which must trip its own code and no other
CODE_SNIPPETS = {
    "RT001": """
        import torch


        def rebuild(fns):
            for fn in fns:
                torch.library.custom_op("ns::op", fn, mutates_args=())
    """,
    "RT002": """
        import torch


        def body(x):
            return x * x.item()


        fn = torch.func.vmap(body)
    """,
    "RT003": """
        import torch


        def body(x):
            if x.sum() > 0:
                return x
            return -x


        fn = torch.func.vmap(body)
    """,
    "PK001": """
        from aggregathor_tpu_torch.parallel.engine import stream_generator


        def twins(seed, step, w):
            return stream_generator(seed, step, w, 3, "cpu"), stream_generator(seed, step, w, 3, "cpu")
    """,
    "PK002": """
        import numpy as np


        def dropped(seed):
            rng = np.random.default_rng(seed)
            return seed
    """,
    "PK003": """
        import torch


        def keyless(n):
            return torch.randperm(n)
    """,
    "CC001": """
        import threading


        class Worker:
            def __init__(self):
                self._thread = threading.Thread(target=self._run)

            def _run(self):
                self.done = True
    """,
    "CC002": """
        import threading

        import torch.distributed as dist


        class Worker:
            def __init__(self, rows):
                self._thread = threading.Thread(target=self._run, args=(rows,))

            def _run(self, rows):
                dist.barrier()
    """,
    "EV001": """
        from aggregathor_tpu_torch.obs import events


        def fire(step):
            events.emit("not_a_declared_event", step=step)
    """,
    "EV002": """
        from aggregathor_tpu_torch.obs import events


        def fire(step):
            events.emit("guardian_rollback", step=step)
    """,
}


@pytest.mark.parametrize("code", sorted(CODE_SNIPPETS))
def test_each_code_s_fixture_trips_only_its_code(tmp_path, code):
    module = snippet_module(tmp_path, "seeded_%s.py" % code.lower(), CODE_SNIPPETS[code])
    found = [f for findings in run_ast_checkers(module).values() for f in findings]
    assert found and {f.code for f in found} == {code}, found


EVENTS_SNIPPET = """
    from aggregathor_tpu_torch.obs import events


    def good(step, ref):
        events.emit("run_start", step=step)            # declared: clean
        events.emit("guardian_rollback", step=step,
                    cause=None)                        # action, kwarg said
        events.emit("supervisor_retune", step=step,
                    cause=ref)                         # action, kwarg said


    def bad(step, kind):
        events.emit("totally_new_event", step=step)    # EV001: undeclared
        events.emit(kind, step=step)                   # EV001: dynamic
        events.emit()                                  # EV001: missing
        events.emit("supervisor_restart", step=step)   # EV002: no cause=
"""


def test_events_fixture_trips_only_events(tmp_path):
    module = snippet_module(tmp_path, "seeded_events.py", EVENTS_SNIPPET)
    results = run_ast_checkers(module)
    findings = results["events"]
    assert sorted({f.code for f in findings}) == ["EV001", "EV002"], findings
    assert {f.symbol for f in findings} == {"totally_new_event", "<dynamic>", "<missing>", "supervisor_restart"}
    assert all(f.scope == "bad" for f in findings)
    assert [f.symbol for f in findings if f.code == "EV002"] == ["supervisor_restart"]
    only(results, "events")


def test_events_checker_ignores_unrelated_emit(tmp_path):
    module = snippet_module(tmp_path, "unrelated_emit.py", """
        class Bus:
            def emit(self, kind):
                pass


        def fire(bus, emit):
            bus.emit("whatever")
            emit("also fine")
    """)
    assert CHECKERS["events"].check([module]) == []


def test_events_checker_resolves_the_port_s_imports(tmp_path):
    """The relative imports the port uses (``from ..obs import events as
    obs_events``, ``from ..obs.events import emit``) and the absolute
    module resolve; ``obs/events.py`` itself is excluded."""
    module = snippet_module(tmp_path, "serve/aliased.py", """
        import aggregathor_tpu_torch.obs.events
        from ..obs import events as obs_events
        from ..obs.events import emit


        def f(step):
            obs_events.emit("nope_a", step=step)
            emit("nope_b", step=step)
            aggregathor_tpu_torch.obs.events.emit("nope_c", step=step)
    """)
    findings = CHECKERS["events"].check([module])
    assert {f.symbol for f in findings} == {"nope_a", "nope_b", "nope_c"}
    excluded = core.Module(str(tmp_path), "obs/events.py", textwrap.dedent("""
        from .events import emit


        def relay(journal, etype):
            emit(etype)
    """))
    assert CHECKERS["events"].check([excluded]) == []


def test_events_checker_whole_package_clean():
    modules, errors = core.scan_modules()
    assert errors == []
    findings = CHECKERS["events"].check(modules)
    assert findings == [], "\n".join(f.render() for f in findings)


class _LyingGAR(gars.GAR):
    """Seeded gar-contract violation: every declaration is false.

    Declares NaN tolerance but averages (GC001), skips the feasibility floor
    (GC002), reports a participation scatter summing to 2 (GC003) and
    returns float64 (GC004)."""

    nan_row_tolerant = True
    coordinate_wise = True

    def check(self):  # deliberately bypasses the f < n floor
        pass

    def aggregate_block(self, block, dist2=None):
        return torch.mean(block, dim=0).to(torch.float64)

    def worker_participation(self, dist2):
        return torch.full((self.nb_workers,), 2.0 / self.nb_workers)


def test_gar_contract_fixture_convicts_every_false_claim():
    name = "lying-gar-fixture"
    gars.gars._register[name] = _LyingGAR
    try:
        findings = gar_contract.check_spec(name, "cpu")
    finally:
        del gars.gars._register[name]
    assert {f.checker for f in findings} == {"gar-contract"}
    assert {"GC001", "GC002", "GC003", "GC004"} <= {f.code for f in findings}, findings
    assert ("GC004", "dtype") in {(f.code, f.symbol) for f in findings}


def test_gar_contract_constructor_crash_is_a_finding_not_a_crash():
    class _CrashyGAR(gars.GAR):
        def __init__(self, nb_workers, nb_byz_workers, args=None):
            raise TypeError("constructor exploded")

    name = "crashy-gar-fixture"
    gars.gars._register[name] = _CrashyGAR
    try:
        findings = gar_contract.check_spec(name, "cpu")
    finally:
        del gars.gars._register[name]
    assert [f.code for f in findings] == ["GC000"]
    assert "TypeError" in findings[0].message


# --------------------------------------------------------------------- #
# baseline lifecycle: add -> (red) -> justify -> (green) -> expire -> (red)


def _finding(symbol="x"):
    return core.Finding(checker="concurrency", code="CC001", path="pkg/mod.py", line=7, scope="Cls.fn",
                        symbol=symbol, message="seeded")


def test_baseline_round_trip(tmp_path):
    path = str(tmp_path / "baseline.json")
    finding = _finding()
    unb, base, issues = baseline_mod.apply([finding], baseline_mod.load(path))
    assert [f.fingerprint for f in unb] == [finding.fingerprint] and base == [] and issues == []
    # an EMPTY justification matches, but BL002 keeps the gate red
    baseline_mod.save(path, {finding.fingerprint: ""})
    unb, base, issues = baseline_mod.apply([finding], baseline_mod.load(path))
    assert unb == [] and [f.code for f in issues] == ["BL002"]
    baseline_mod.save(path, {finding.fingerprint: "single-writer telemetry"})
    unb, base, issues = baseline_mod.apply([finding], baseline_mod.load(path))
    assert unb == [] and issues == [] and [f.fingerprint for f in base] == [finding.fingerprint]
    # line drift does not expire the entry (fingerprints are line-free)
    moved = core.Finding(**{**finding.__dict__, "line": 99})
    unb, base, issues = baseline_mod.apply([moved], baseline_mod.load(path))
    assert unb == [] and issues == []
    # fixed: the entry goes stale -> BL001
    unb, base, issues = baseline_mod.apply([], baseline_mod.load(path))
    assert [f.code for f in issues] == ["BL001"]
    other = _finding(symbol="y")
    unb, base, issues = baseline_mod.apply([other], baseline_mod.load(path))
    assert [f.fingerprint for f in unb] == [other.fingerprint] and [f.code for f in issues] == ["BL001"]


def test_baseline_rejects_malformed(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": 999, "entries": []}))
    with pytest.raises(ValueError):
        baseline_mod.load(str(path))
    path.write_text(json.dumps({"version": 1, "entries": [{"nope": 1}]}))
    with pytest.raises(ValueError):
        baseline_mod.load(str(path))


def test_report_schema_round_trip(tmp_path):
    doc = report_mod.build_report(
        root="pkg", checkers=["concurrency"], unbaselined=[_finding()], baselined=[_finding("b")], issues=[],
        justifications={_finding("b").fingerprint: "why"},
    )
    report_mod.validate_report(doc)
    assert doc["schema"] == "aggregathor.analysis.report.v1"
    assert doc["counts"] == {"total": 2, "unbaselined": 1, "baselined": 1, "baseline_issues": 0}
    assert doc["clean"] is False
    path = tmp_path / "report.json"
    report_mod.save_report(str(path), doc)
    report_mod.validate_report(json.loads(path.read_text()))
    with pytest.raises(ValueError):
        report_mod.validate_report(dict(doc, clean=True))


def test_the_jax_package_s_reader_takes_the_port_s_report(tmp_path):
    from aggregathor_tpu.analysis.report import validate_report

    out = tmp_path / "report.json"
    assert main(["--device", "cpu", "--json", str(out), "-q"]) == 0
    doc = validate_report(json.loads(out.read_text()))
    assert doc["root"] == core.package_root() and doc["root"].endswith("aggregathor_tpu_torch")


# --------------------------------------------------------------------- #
# GAR contract sweep: JAX's spec list, JAX's sizes, the registry's whole


def test_gar_contract_sweep_is_jax_s_spec_list():
    specs = gar_contract.default_specs()
    assert specs == jax_gar_contract.default_specs()
    assert not set(gars.itemize()) - set(specs)  # a rule cannot register without entering the sweep
    assert gar_contract.COMPOSITE_SPECS == jax_gar_contract.COMPOSITE_SPECS
    assert gar_contract.CANDIDATES == jax_gar_contract.CANDIDATES
    assert gar_contract.PROBE_D == jax_gar_contract.PROBE_D


@pytest.mark.parametrize("spec", jax_gar_contract.default_specs())
def test_gar_contract_probe_sizes_are_jax_s(spec):
    gar, n, f = gar_contract._feasible(spec)
    jax_gar, jax_n, jax_f = jax_gar_contract._feasible(spec)
    assert gar is not None and jax_gar is not None
    assert (n, f) == (jax_n, jax_f) and 0 <= f < n
    assert gar.nan_row_tolerant == jax_gar.nan_row_tolerant


def test_gar_contract_probe_rows_are_jax_s():
    import numpy as np

    want = np.random.default_rng(0x6A2).normal(size=(8, jax_gar_contract.PROBE_D)).astype(np.float32)
    assert np.array_equal(gar_contract.probe_rows(8), want)


def test_gar_contract_sweep_is_clean():
    findings = gar_contract.check(device="cpu")
    assert findings == [], "\n".join(f.render() for f in findings)


def test_gar_contract_sweep_is_cached_per_process():
    assert gar_contract.check(device="cpu") == gar_contract.check(device=torch.device("cpu"))
    assert gar_contract._check_cached.cache_info().hits >= 1


def test_every_gar_rejects_byzantine_majority_of_everyone():
    for name in gars.itemize():
        with pytest.raises(UserException):
            gars.instantiate(name, 3, 3)
        with pytest.raises(UserException):
            gars.instantiate(name, 2, 5)


def test_feasibility_floor_keeps_boundary_configs():
    gars.instantiate("average", 1, 0)
    gars.instantiate("average-nan", 4, 3)
    with pytest.raises(UserException):
        gars.instantiate("krum", 4, 3)  # krum wants n >= f + 3


# --------------------------------------------------------------------- #
# the whole-package gate and the CLI


def test_clean_package_with_shipped_baseline():
    """The acceptance gate: zero unbaselined findings, zero baseline issues
    over the whole port, and every entry justifying a live finding."""
    findings, errors = run_checkers(device="cpu")
    assert errors == [], "\n".join(f.render() for f in errors)
    entries = baseline_mod.load(baseline_mod.default_baseline_path())
    unbaselined, baselined, issues = baseline_mod.apply(findings, entries)
    assert unbaselined == [], "\n".join(f.render() for f in unbaselined)
    assert issues == [], "\n".join(f.render() for f in issues)
    assert {f.fingerprint for f in baselined} == set(entries)
    assert all(justification.strip() for justification in entries.values())


def test_package_scan_is_cached_per_session():
    root = core.package_root()
    assert root.endswith("aggregathor_tpu_torch")
    paths = core.iter_package_paths(root)
    assert "analysis/retrace.py" in paths and "parallel/bounded.py" in paths
    assert core.load_module(root, paths[0]) is core.load_module(root, paths[0])


def test_cli_reports_clean_and_validates_json(tmp_path):
    out = str(tmp_path / "report.json")
    assert main(["--device", "cpu", "--json", out, "--check", "-q"]) == 0
    doc = report_mod.validate_report(json.loads(open(out).read()))
    assert doc["clean"] is True and doc["counts"]["unbaselined"] == 0
    with pytest.raises(SystemExit):
        main(["--checkers", "definitely-not-a-checker"])


def test_cli_without_device_cpu_raises_without_a_gpu(monkeypatch):
    """The sweep's default is the card: without one it raises, never
    carrying on on the CPU; the AST checkers need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UserException, match="no GPU"):
        main(["-q"])
    with pytest.raises(UserException, match="no GPU"):
        run_checkers(checkers=["gar-contract"])
    assert main(["--checkers", "retrace,prng,concurrency,events", "--check", "-q"]) == 0


def test_cli_no_baseline_lists_only_the_baselined_findings(capsys):
    assert main(["--device", "cpu", "--no-baseline"]) == 1
    lines = [line for line in capsys.readouterr().out.splitlines() if line and not line.startswith("graftcheck:")]
    entries = baseline_mod.load(baseline_mod.default_baseline_path())
    assert lines and all(any(fp.split(" ", 2)[1] in line for fp in entries) for line in lines)


def test_cli_rejects_unknown_checker_via_api():
    with pytest.raises(ValueError):
        run_checkers(checkers=["nope"])


def test_checker_subset_does_not_stale_other_checkers_entries():
    cc = _finding()
    entries = {cc.fingerprint: "justified elsewhere"}
    _, _, issues = baseline_mod.apply([], entries, active_codes=active_codes(["prng"]))
    assert issues == []
    _, _, issues = baseline_mod.apply([], entries, active_codes=active_codes(["concurrency"]))
    assert [f.code for f in issues] == ["BL001"]
    for name in CHECKERS:
        assert main(["--checkers", name, "--check", "-q", "--device", "cpu"]) == 0, name


# --------------------------------------------------------------------- #
# checker unit behavior worth pinning (the idioms the port relies on)


def test_retrace_finds_the_port_s_transformed_scopes():
    """The workers' and the leaf buckets' vmaps, a custom op's batching
    rule, an autograd Function under generate_vmap_rule, every rule's entry
    points and the experiments' losses."""
    root = core.package_root()
    want = {
        "parallel/engine.py": {"RobustEngine._aggregate_per_leaf_bucketed.per_leaf", "RobustEngine._prepare_rows"},
        "ops/kernels.py": {"_custom_op.rule", "_leading"},
        "models/common.py": {"ConvF64WeightGrad.forward", "ConvF64WeightGrad.backward"},
        "gars/krum.py": {"KrumGAR.aggregate_block", "KrumGAR.selection_weights"},
        "gars/bulyan.py": {"BulyanGAR.aggregate_block"},
        "models/transformer.py": {"TransformerExperiment.loss", "attention_block"},
        "models/zoo.py": {"ZooExperiment.loss"},
    }
    for path, scopes in want.items():
        module = core.load_module(root, path)
        found = {module.qualname(f) for f in retrace.find_transformed_functions(module)}
        assert scopes <= found, (path, scopes - found)


def test_retrace_static_projections_stay_static(tmp_path):
    module = snippet_module(tmp_path, "shapes.py", """
        import torch


        def body(x, cfg, axis, key):
            n, d = x.shape
            if n > 3 and x.dim() == 2 and x.numel() > 0:    # static: shape projections
                x = x + 1.0
            if cfg.deep:                                   # static: config record
                x = x * 2.0
            if axis is not None and key is not None:       # static: host values
                x = x - 1.0
            if x.dtype == torch.float32 and x.device.type == "cuda":
                x = x * 1.0
            return torch.sum(x) / d


        fn = torch.func.vmap(body, in_dims=(0, None, None, None))
    """)
    assert retrace.check([module]) == []


def test_retrace_traced_helpers_are_reached_transitively(tmp_path):
    module = snippet_module(tmp_path, "reach.py", """
        import torch


        def _helper(x):
            return float(x)                     # RT002, via reachability


        def _sync(x):
            torch.cuda.synchronize()            # RT002 anywhere in a transformed scope
            return x


        def build():
            def body(x):
                return _helper(x) + _sync(x)

            return torch.vmap(body)


        def alias_and_lambda(loss):
            fn = _aliased
            return torch.func.vmap(fn), torch.func.grad(lambda p: _through_lambda(p))


        def _aliased(x):
            return x.tolist()                   # RT002 through one alias hop


        def _through_lambda(p):
            return p.cpu()                      # RT002 through a lambda's call
    """)
    found = sorted((f.scope, f.code, f.symbol) for f in retrace.check([module]))
    assert found == [("_aliased", "RT002", "tolist"), ("_helper", "RT002", "float"),
                     ("_sync", "RT002", "torch.cuda.synchronize"), ("_through_lambda", "RT002", "cpu")], found


def test_retrace_autograd_grad_is_no_transform(tmp_path):
    module = snippet_module(tmp_path, "autograd.py", """
        import torch


        def loss(x):
            if x.sum() > 0:
                return x.item()
            return 0.0


        def step(params):
            out = loss(params)
            return torch.autograd.grad(out, params)
    """)
    assert retrace.check([module]) == []


def test_concurrency_requires_a_spawn_site(tmp_path):
    module = snippet_module(tmp_path, "nospawn.py", """
        import torch.distributed as dist


        class Plain:
            def poke(self, rows):
                self.count = 1                  # no threads: not our business
                dist.all_reduce(rows)
    """)
    assert concurrency.check([module]) == []


def test_concurrency_sees_the_port_s_spawn_sites():
    """The bounded-wait pool's submission thread, the input pipeline and
    prefetcher, the serving and fleet threads, the checkpoint writer, and
    the runner's and server's helpers; the dispatch and round locks count
    as locks, and bounded-wait's submission path is CC-clean."""
    import ast

    root = core.package_root()
    want = {
        "parallel/bounded.py": "BoundedWaitStep._submit_one", "models/datasets.py": "ChunkPipeline._run",
        "serve/continuous.py": "ContinuousBatcher._lane", "serve/autoscale.py": "PoolAutoscaler._run",
        "serve/weights.py": "CheckpointWatcher._run", "serve/frontend.py": "InferenceServer._loop_main",
        "serve/router.py": "FleetRouter.start.run", "obs/fleet.py": "FleetCollector.start.run",
        "obs/checkpoint.py": "Checkpoints._write", "cli/runner.py": "wait_for_cuda.probe",
        "cli/serve.py": "main.on_drain.wait_quiescent",
    }
    for path, target in want.items():
        module = core.load_module(root, path)
        assert target in {module.qualname(f) for f in concurrency._spawn_targets(module)}, path
    for name in ("self._dispatch_lock", "self._round_lock"):
        assert concurrency._is_lockish(ast.parse(name, mode="eval").body), name
    assert concurrency.check([core.load_module(root, "parallel/bounded.py")]) == []


def test_concurrency_lockish_matches_tokens_not_substrings(tmp_path):
    module = snippet_module(tmp_path, "lockish.py", """
        import threading


        class S:
            def __init__(self):
                self._t = threading.Thread(target=self._run)

            def _run(self):
                with self.assembler:
                    self.count = 1                # NOT a lock: CC001
                with self.round_lock:
                    self.count = 2                # token 'lock': fine
                with self._dispatch_lock:
                    self.count = 3                # bounded-wait's: fine
    """)
    findings = concurrency.check([module])
    assert [(f.line, f.code) for f in findings] == [(11, "CC001")], findings


def test_concurrency_alias_of_shared_state_is_not_private(tmp_path):
    module = snippet_module(tmp_path, "alias.py", """
        import threading


        class S:
            def __init__(self):
                self._t = threading.Thread(target=self._run)

            def _run(self):
                st = self.state
                st.count = 1                  # CC001 through the alias
                mine = object()
                mine.tag = 2                  # genuinely private: fine
    """)
    assert [(f.symbol, f.code) for f in concurrency.check([module])] == [("st.count", "CC001")]


def test_prng_distinct_tags_are_distinct_streams(tmp_path):
    module = snippet_module(tmp_path, "streams.py", """
        import torch

        from aggregathor_tpu_torch.parallel.engine import stream_generator
        from aggregathor_tpu_torch.utils import fold_in_seed


        def derive(seed, step, w):
            a = stream_generator(seed, step, w, 1, "cpu")
            b = stream_generator(seed, step, w, 2, "cpu")       # distinct tag: fine
            x = torch.rand(2, generator=a)
            y = torch.rand(2, generator=a)                      # one stream read twice: fine
            return x + y + torch.rand(2, generator=b)


        def per_worker(seed, step, k):
            out = []
            for w in range(k):
                gen = stream_generator(seed, step, w, 1, "cpu")   # loop-varying: fine
                out.append(torch.randn(3, generator=gen))
            return out


        def collide(seed, step):
            a = fold_in_seed(fold_in_seed(seed, step), 7)
            b = fold_in_seed(fold_in_seed(seed, step), 7)       # SAME seed: PK001
            return a, b
    """)
    findings = prng.check([module])
    assert sorted((f.scope, f.code, f.symbol) for f in findings) == [
        ("collide", "PK001", "fold_in_seed"), ("collide", "PK001", "fold_in_seed")], findings


def test_prng_keyed_draws_pass(tmp_path):
    module = snippet_module(tmp_path, "keyed.py", """
        import numpy as np
        import torch


        def draws(seed, n, text):
            rng = np.random.default_rng([seed, 3])
            gen = torch.Generator("cpu").manual_seed(seed)
            key, value = text.split("=", 1)
            rows = torch.empty(n).uniform_(generator=gen)
            return rng.normal(size=n) + rows.numpy() + torch.randperm(n, generator=gen).numpy(), key, value
    """)
    assert prng.check([module]) == []


def test_prng_branch_arm_seeds_survive_the_join(tmp_path):
    module = snippet_module(tmp_path, "branchseed.py", """
        from aggregathor_tpu_torch.utils import fold_in_seed


        def step(seed, flag):
            if flag:
                a = fold_in_seed(seed, 1)
            b = fold_in_seed(seed, 1)      # collides when flag is True
            return b


        def arms(seed, flag):
            if flag:
                a = fold_in_seed(seed, 1)
            else:
                a = fold_in_seed(seed, 1)  # the other path: fine
            return a
    """)
    assert [(f.scope, f.code) for f in prng.check([module])] == [("step", "PK001")]


def test_prng_entropy_seeded_and_stdlib_draws_are_keyless(tmp_path):
    module = snippet_module(tmp_path, "entropy.py", """
        import random

        import numpy as np
        import torch


        def draws(x):
            x.normal_()
            return np.random.default_rng(), random.random(), torch.rand_like(x)
    """)
    found = sorted(f.symbol for f in prng.check([module]))
    assert found == [".normal_", "np.random.default_rng()", "random.random", "torch.rand_like"], found


def test_prng_the_port_s_tag_spaces():
    """Among the port's stream tags only the forge verdict shares a value,
    with the lateness draw, by design (trap s, baselined)."""
    modules, _ = core.scan_modules()
    assert [f.symbol for f in prng.check_tags(modules)] == ["FORGE_TAG=STRAGGLER_KEY_TAG"]


def test_module_cache_is_per_root(tmp_path):
    inner = tmp_path / "pkg"
    inner.mkdir()
    (inner / "m.py").write_text("x = 1\n")
    a = core.load_module(str(tmp_path), "pkg/m.py")
    b = core.load_module(str(inner), "m.py")
    assert a.path == "pkg/m.py" and b.path == "m.py"


def test_finding_fingerprint_is_line_free():
    a = _finding()
    b = core.Finding(**{**a.__dict__, "line": 1234})
    assert a.fingerprint == b.fingerprint and "1234" not in a.fingerprint
