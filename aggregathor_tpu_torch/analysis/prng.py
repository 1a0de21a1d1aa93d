"""Generator hygiene: every draw keyed per (seed, step, worker, tag), no two
streams from one key.

Counterpart of ``aggregathor_tpu/analysis/prng.py``.  A JAX key is a value:
feeding one key to two samplers yields identical draws, which the JAX
checker convicts.  A ``torch.Generator`` is a stream, so drawing twice from
one generator is no reuse; the port's streams are int seeds folded with
``utils.fold_in_seed`` and generators seeded per (seed, step, worker, tag)
by ``parallel.engine.stream_generator``.  The codes' counterparts:

- **PK001 one key, two streams** -- two streams seeded from the same key:
  textually identical ``stream_generator(...)``, ``fold_in_seed(...)``,
  ``np.random.default_rng(...)`` calls, or ``.manual_seed(x)`` calls with
  the same ``x``, in one straight-line region (both mint the SAME stream);
  and two distinct ``*_TAG`` constants of the package with equal values
  (their (seed, step, worker, tag) streams coincide: the tag spaces of
  ROADMAP traps c, n, s and aq).
- **PK002 minted and dropped** -- a generator made (``torch.Generator``,
  ``stream_generator``, ``np.random.default_rng``/``RandomState``) and
  never read: bound to a name that is never loaded afterwards, or a bare
  expression statement.
- **PK003 keyless draw** -- a sampler that reads the process-wide stream,
  which no (seed, step, worker, tag) keys: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``bernoulli``, ``multinomial``, ``normal``,
  ``poisson`` (and the ``*_like`` forms, which take no generator) with no
  ``generator=``; the in-place ``.uniform_()``, ``.normal_()``,
  ``.bernoulli_()``, ``.random_()``, ``.exponential_()`` with no
  ``generator=``; a module-level ``np.random.<sampler>`` or the stdlib's
  ``random.<sampler>``; ``np.random.default_rng()`` or ``RandomState()``
  with no seed.  ``np.random.default_rng(seed)`` streams are keyed and
  pass.  It is the one way torch can break trap c that JAX cannot express,
  since every JAX draw takes a key.

Approximation contract (as in JAX): branches fork the region and merge
optimistically (every arm's seeds stay recorded past the join; duplicates
ACROSS arms are distinct paths); loop bodies start a fresh region, since
``stream_generator(seed, step, w, TAG, ...)`` with a loop-varying ``w`` is
the idiom.  Both choices trade recall for a near-zero false-positive rate.
"""

import ast

from .core import Finding, callee_name

CHECKER = "prng"

#: calls that mint a stream from their arguments (PK001's textual identity)
SEEDERS = frozenset({"stream_generator", "fold_in_seed", "default_rng", "manual_seed"})

#: calls that make a generator (PK002 when never read)
GENERATOR_MAKERS = frozenset({"Generator", "stream_generator", "default_rng", "RandomState"})

#: torch samplers that take ``generator=``; the ``*_like`` ones take none
TORCH_SAMPLERS = frozenset({"rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal",
                            "poisson"})
TORCH_KEYLESS = frozenset({"rand_like", "randn_like", "randint_like"})
INPLACE_SAMPLERS = frozenset({"uniform_", "normal_", "bernoulli_", "random_", "exponential_", "cauchy_",
                              "log_normal_", "geometric_"})

#: np.random module-level samplers (the legacy global RandomState)
NUMPY_SAMPLERS = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "ranf", "sample", "uniform", "normal", "choice",
    "permutation", "shuffle", "binomial", "poisson", "exponential", "standard_normal", "beta", "gamma",
    "laplace", "multinomial", "bytes",
})

#: the stdlib ``random`` module's samplers
STDLIB_SAMPLERS = frozenset({"random", "uniform", "randint", "randrange", "choice", "choices", "shuffle",
                             "sample", "gauss", "normalvariate", "getrandbits", "expovariate"})


def _tail(call):
    name = callee_name(call)
    if name is not None:
        return name.rsplit(".", 1)[-1]
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _seed_identity(call):
    """The identity of the stream ``call`` mints, or None: the seeder and
    the dump of its arguments (a ``.manual_seed(x)`` without its receiver:
    two generators seeded with one ``x`` are one stream)."""
    tail = _tail(call)
    if tail not in SEEDERS:
        return None
    if tail == "default_rng" and not call.args and not call.keywords:
        return None  # entropy-seeded: PK003's business
    args = [ast.dump(a) for a in call.args] + [
        "%s=%s" % (kw.arg, ast.dump(kw.value)) for kw in call.keywords]
    return tail, tuple(args)


def _generator_maker(call):
    """True when ``call`` makes a generator (or seeds a fresh one)."""
    tail = _tail(call)
    if tail in GENERATOR_MAKERS:
        return True
    return (tail == "manual_seed" and isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Call) and _tail(call.func.value) == "Generator")


def _stdlib_random_aliases(module):
    aliases = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "random":
                    aliases.add(alias.asname or "random")
    return aliases


def _keyless(call, random_aliases):
    """The keyless sampler's name when ``call`` draws from a process-wide
    stream, else None."""
    name = callee_name(call) or ""
    has_generator = any(kw.arg == "generator" for kw in call.keywords)
    base, _, tail = name.rpartition(".")
    if base == "torch" and tail in TORCH_KEYLESS:
        return name
    if base == "torch" and tail in TORCH_SAMPLERS and not has_generator:
        return name
    if isinstance(call.func, ast.Attribute) and call.func.attr in INPLACE_SAMPLERS and not has_generator:
        return "." + call.func.attr
    if base in ("np.random", "numpy.random"):
        if tail in NUMPY_SAMPLERS:
            return name
        if tail in ("default_rng", "RandomState") and not call.args and not call.keywords:
            return name + "()"
    if base in random_aliases and tail in STDLIB_SAMPLERS:
        return name
    return None


class _Region:
    """The streams minted so far in one straight-line region; forked at branches."""

    def __init__(self, seen=None):
        self.seen = dict(seen or {})  # identity -> first line

    def fork(self):
        return _Region(self.seen)

    def merge(self, *branches):
        for branch in branches:
            for identity, line in branch.seen.items():
                self.seen.setdefault(identity, line)


class Checker:
    def __init__(self, module, func):
        self.module = module
        self.func = func
        self.scope = module.qualname(func)
        self.findings = []

    def finding(self, code, line, symbol, message):
        self.findings.append(Finding(CHECKER, code, self.module.path, line, self.scope, symbol, message))

    def run(self):
        self._block(self.func.body, _Region())
        self._unread_generators()
        return self.findings

    def _unread_generators(self):
        """PK002: a generator bound to a name never loaded after its binding."""
        loads = {}
        for node in ast.walk(self.func):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                loads.setdefault(node.id, []).append(node.lineno)
        for node in ast.walk(self.func):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and _generator_maker(node.value)):
                continue
            if _owner(self.module, node) is not self.func:
                continue
            for target in node.targets:
                if not isinstance(target, ast.Name) or target.id.startswith("_"):
                    continue
                if not any(at >= node.lineno for at in loads.get(target.id, [])):
                    self.finding(
                        "PK002", node.lineno, target.id,
                        "generator %r is made and never read: a stream minted and dropped -- the "
                        "draws it was made for probably come from another stream" % target.id,
                    )

    def _block(self, stmts, region):
        for stmt in stmts:
            self._stmt(stmt, region)

    def _stmt(self, stmt, region):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs get their own Checker
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, region)
            then, other = region.fork(), region.fork()
            self._block(stmt.body, then)
            self._block(stmt.orelse, other)
            region.merge(then, other)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            self._expr(stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) else stmt.test, region)
            self._block(stmt.body, _Region())
            self._block(stmt.orelse, region)
            return
        if isinstance(stmt, ast.Try):
            body = region.fork()
            self._block(stmt.body, body)
            for handler in stmt.handlers:
                self._block(handler.body, region.fork())
            self._block(stmt.orelse, body)
            self._block(stmt.finalbody, body)
            region.merge(body)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr, region)
            self._block(stmt.body, region)
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) and _generator_maker(stmt.value):
            self.finding(
                "PK002", stmt.lineno, _tail(stmt.value),
                "%s(...) result discarded: a generator made and dropped" % _tail(stmt.value),
            )
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, region)
            elif isinstance(child, ast.stmt):
                self._stmt(child, region)

    def _expr(self, expr, region):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            identity = _seed_identity(node)
            if identity is None:
                continue
            if identity in region.seen:
                self.finding(
                    "PK001", node.lineno, identity[0],
                    "%s(...) with the same arguments as at line %d in one region: both mint the "
                    "SAME stream" % (identity[0], region.seen[identity]),
                )
            else:
                region.seen[identity] = node.lineno


def _owner(module, node):
    cur = module.parent(node)
    while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        cur = module.parent(cur)
    return cur


def _tag_constants(module):
    """(name, value, line) of the module-level ``*_TAG = <int>`` constants."""
    found = []
    for stmt in module.tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        target = stmt.targets[0]
        if not (isinstance(target, ast.Name) and target.id.endswith("_TAG")):
            continue
        try:
            value = ast.literal_eval(stmt.value)
        except ValueError:
            continue
        if isinstance(value, int) and not isinstance(value, bool):
            found.append((target.id, value, stmt.lineno))
    return found


def check_tags(modules):
    """PK001 for distinct ``*_TAG`` names of equal value across ``modules``."""
    by_value = {}
    for module in modules:
        for name, value, line in _tag_constants(module):
            by_value.setdefault(value, []).append((module.path, line, name))
    findings = []
    for value, sites in sorted(by_value.items()):
        names = sorted({name for _, _, name in sites})
        if len(names) < 2:
            continue  # one name (a copy of it in another module is the same tag)
        path, line, _ = min(sites)
        findings.append(Finding(
            CHECKER, "PK001", path, line, "<tags>", "=".join(names),
            "tags %s share the value %d: their (seed, step, worker, tag) streams are one stream (%s)"
            % (", ".join(names), value, ", ".join("%s:%d %s" % site for site in sorted(sites))),
        ))
    return findings


def check_module(module):
    findings = []
    random_aliases = _stdlib_random_aliases(module)
    for func in module.functions():
        findings.extend(Checker(module, func).run())
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            sampler = _keyless(node, random_aliases)
            if sampler is not None:
                owner = _owner(module, node)
                findings.append(Finding(
                    CHECKER, "PK003", module.path, node.lineno,
                    module.qualname(owner) if owner is not None else "", sampler,
                    "%s draws from the process-wide stream, which no (seed, step, worker, tag) keys: "
                    "pass generator= (a stream_generator) or use a seeded np.random.default_rng" % sampler,
                ))
    return findings


def check(modules):
    findings = []
    for module in modules:
        findings.extend(check_module(module))
    findings.extend(check_tags(modules))
    return findings
