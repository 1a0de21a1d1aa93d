"""graftcheck core: findings, the cached package scan, and call-graph glue.

Counterpart of ``aggregathor_tpu/analysis/core.py``, copied (it holds no
JAX) and pointed at this package.  The static pass exists because the
load-bearing invariants of the port -- no kernel built after the first
step and no host read inside a ``torch.func`` transform, every random draw
keyed per (seed, step, worker, tag), host threads never touching shared
state unlocked nor meeting the default group's collectives out of step,
every journal emit declared, every GAR honoring its declared contract --
are otherwise enforced only *dynamically*, at the configurations the tests
happen to run.  A checker proves (a conservative approximation of) the
property everywhere in the package.

Design rules shared by every checker:

- **Findings are data.**  A checker returns :class:`Finding` records; it
  never prints, never exits.  Presentation, baselining and exit codes live
  in ``baseline.py`` / ``__main__.py``.
- **Fingerprints are line-number-free.**  A finding's identity is
  ``CODE path scope symbol`` -- moving code inside a file never churns the
  baseline.  The deliberate cost: a SECOND violation of the same kind on
  the same symbol in the same scope rides the existing entry (one entry ==
  one accepted *pattern* per scope, not one statement).
- **Parse once per process.**  Whole-package AST scans go through
  :func:`scan_modules`, memoized on ``(path, mtime, size)``: the tests run
  every checker plus the clean-package assertion over the same files.
"""

import ast
import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker verdict.

    Attributes:
      checker: checker name (``retrace`` / ``prng`` / ``concurrency`` /
        ``gar-contract`` / ``events`` / ``baseline``).
      code: stable rule code (``RT002``, ``PK001``, ...) — the unit docs
        and baselines speak in.
      path: package-relative file path (or a symbolic path such as
        ``gars/<spec>`` for semantic findings with no single source line).
      line: 1-based line number, 0 when not tied to a line.
      scope: dotted function qualname (or GAR spec) the finding lives in.
      symbol: the short stable detail (attribute name, callee, key name)
        that disambiguates two findings in one scope.
      message: human sentence, shown in reports.
    """

    checker: str
    code: str
    path: str
    line: int
    scope: str
    symbol: str
    message: str

    @property
    def fingerprint(self):
        """Stable identity for baselining: everything but the line number."""
        return "%s %s %s %s" % (self.code, self.path, self.scope, self.symbol)

    def render(self):
        return "%s:%d: %s [%s] %s (in %s)" % (
            self.path, self.line, self.checker, self.code, self.message,
            self.scope or "<module>",
        )

    def to_json(self):
        doc = dataclasses.asdict(self)
        doc["fingerprint"] = self.fingerprint
        return doc


class Module:
    """One parsed source file: path, source, AST with parent links."""

    def __init__(self, root, relpath, source):
        self.root = root
        self.path = relpath
        self.source = source
        self.tree = ast.parse(source, filename=relpath)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._graft_parent = node

    def parent(self, node):
        return getattr(node, "_graft_parent", None)

    def qualname(self, node):
        """Dotted qualname of a FunctionDef/ClassDef by walking parents."""
        names = []
        while node is not None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.append(node.name)
            node = self.parent(node)
        return ".".join(reversed(names))

    def functions(self):
        """Every (async) function definition in the module."""
        return [
            node for node in ast.walk(self.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]


#: (root, relpath) -> (mtime, size, Module) — the per-process scan cache
#: the tests rely on (every checker and the clean-package assertion
#: re-scan the same files).  Keyed on BOTH root and relpath: the
#: same file reached through two different --root values must yield
#: Modules whose ``path`` (and therefore fingerprints) match each request.
_MODULE_CACHE = {}


def load_module(root, relpath):
    abspath = os.path.join(root, relpath)
    stat = os.stat(abspath)
    key = (os.path.abspath(root), relpath)
    cached = _MODULE_CACHE.get(key)
    if cached is not None and cached[0] == stat.st_mtime_ns and cached[1] == stat.st_size:
        return cached[2]
    with open(abspath, "r", encoding="utf-8") as fh:
        source = fh.read()
    module = Module(root, relpath, source)
    _MODULE_CACHE[key] = (stat.st_mtime_ns, stat.st_size, module)
    return module


def package_root():
    """The installed ``aggregathor_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_package_paths(root):
    """Package-relative paths of every ``.py`` file under ``root``, sorted."""
    found = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                found.append(os.path.relpath(os.path.join(dirpath, name), root))
    return found


def scan_modules(root=None, paths=None):
    """Parse (cached) every requested file; returns a list of Modules.

    Files that fail to parse surface as a synthetic ``core``/``PARSE``
    finding by the caller (`run_checkers`) rather than an exception — a
    syntax error in one file must not hide every other finding.
    """
    root = root or package_root()
    modules, errors = [], []
    for relpath in (paths if paths is not None else iter_package_paths(root)):
        try:
            modules.append(load_module(root, relpath))
        except (SyntaxError, OSError) as exc:
            errors.append(
                Finding(
                    checker="core", code="PARSE", path=relpath,
                    line=getattr(exc, "lineno", 0) or 0, scope="", symbol="parse",
                    message="file does not parse: %s" % (exc,),
                )
            )
    return modules, errors


# --------------------------------------------------------------------- #
# Shared AST helpers


def dotted_name(node):
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def callee_name(call):
    """Dotted callee of a Call node (``torch.func.vmap`` / ``split``), else None."""
    return dotted_name(call.func)


def callee_tail(call):
    """Last segment of the callee (``vmap`` for ``torch.func.vmap``), else None."""
    name = callee_name(call)
    return name.rsplit(".", 1)[-1] if name else None


def enclosing_function(module, node):
    """Innermost (async) function definition containing ``node``."""
    node = module.parent(node)
    while node is not None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node
        node = module.parent(node)
    return None


def enclosing_class(module, node):
    """Innermost class definition containing ``node``."""
    node = module.parent(node)
    while node is not None:
        if isinstance(node, ast.ClassDef):
            return node
        node = module.parent(node)
    return None


def local_call_targets(module, func):
    """Function defs in the SAME module that ``func``'s body may call.

    Intra-module resolution only (the conservative approximation every
    checker shares): bare names resolve to module-level or lexically
    enclosing function defs, ``self.X``/``cls.X`` to methods of the
    enclosing class.  Unresolvable callees (stdlib, other modules) are
    ignored — a checker that needs them must say so in its docs.
    """
    by_name = {}
    for node in module.functions():
        parent = module.parent(node)
        if isinstance(parent, ast.Module):
            by_name.setdefault(node.name, node)
    # lexically enclosing defs (nested helpers)
    enclosing = {}
    scope = func
    while scope is not None:
        for stmt in ast.walk(scope):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt is not scope:
                enclosing.setdefault(stmt.name, stmt)
        scope = enclosing_function(module, scope)
    cls = enclosing_class(module, func)
    methods = {}
    if cls is not None:
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[stmt.name] = stmt
    targets = []
    for call in [n for n in ast.walk(func) if isinstance(n, ast.Call)]:
        fn = call.func
        if isinstance(fn, ast.Name):
            target = enclosing.get(fn.id) or by_name.get(fn.id)
            if target is not None:
                targets.append(target)
        elif isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            if fn.value.id in ("self", "cls") and fn.attr in methods:
                targets.append(methods[fn.attr])
    return targets


def reachable_functions(module, seeds):
    """Transitive closure of ``local_call_targets`` from ``seeds``."""
    seen, frontier = [], list(seeds)
    while frontier:
        func = frontier.pop()
        if any(func is f for f in seen):
            continue
        seen.append(func)
        frontier.extend(local_call_targets(module, func))
    return seen
