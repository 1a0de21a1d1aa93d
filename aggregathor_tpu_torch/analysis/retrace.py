"""Rebuild / host-sync lint: no kernel built per step, no host read under a transform.

Counterpart of ``aggregathor_tpu/analysis/retrace.py``.  Torch has no jit
and no retrace; the port's one compile contract is that no kernel is built
after the first step (``ops/build.py`` builds every source once, the
wrappers register their custom ops once at import), and its transformed
code is what ``torch.func`` runs: the workers' ``vmap(grad_and_value(loss))``
and, under ``--leaf-bucketing on``, every rule ``vmap``ped over a bucket of
leaves.  There a host read or a Python branch on a tensor raises; on the
card it stalls the stream.  The codes keep their JAX meaning in those terms:

- **RT001** -- a kernel build (``ops/build``'s ``build_all``, ``library``,
  ``start_build``) or an op registration (``torch.library.custom_op``,
  ``torch.library.Library``, ``.register_fake``, ``.register_vmap``)
  inside a loop body or a transformed scope: JAX's jit built per call.
  ``build.library`` loads the cached library after its first build, so a
  baselined site argues that the build ran before the first step.
- **RT002** -- a host read of a transformed value inside a transformed
  scope: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float()``/``int()``/``bool()``, ``np.asarray()``/``np.array()``, or
  ``torch.cuda.synchronize()`` anywhere in such a scope.
- **RT003** -- a Python ``if``/``while`` on a transformed value: under vmap
  data-dependent control flow, which raises.
- **RT004** is retired: it flagged jit statics with mutable defaults, and
  torch has no static arguments.

**Transformed scopes** are found syntactically: a function decorated with,
or passed by name to, ``vmap`` (``torch.func.vmap``, ``torch.vmap``),
``grad``, ``grad_and_value``, ``vjp``, ``jvp``, ``jacrev`` or ``jacfwd``,
including through one assignment alias (``fn = per_leaf``, ``fn =
functools.partial(per_leaf, ...)``) and the defs a lambda passed to one
calls; the rule passed to ``.register_vmap``; the static methods of an
``autograd.Function`` that sets ``generate_vmap_rule = True``; under
``gars/``, every rule's ``aggregate_block``, ``aggregate_block_and_
participation``, ``_call_aggregate`` and ``worker_participation``, which
the flat engine's bucketed leaf path vmaps (``parallel/engine.py``
``per_leaf``); and under ``models/`` the experiments' ``loss``, which the
engine vmaps over the workers (``_worker_gradients``).  Those two are calls
across modules, which the intra-module scan cannot follow, so they are
named here (``VMAPPED_ENTRIES``).  Everything lexically nested in, or
intra-module-reachable from, a transformed function is transformed.
**Transformed values** are its parameters and anything assigned from an
expression that reads one; ``.shape``/``.dim()``/``.dtype``/``.device``/
``.numel()``/``.size()``/``len()``/``isinstance()``/``is None``
projections are static, and so are the parameters that carry no tensor in
the port (``self``, ``cfg``, ``axis``, a GAR ``rule``, a vmap rule's
``info`` and ``in_dims``, an autograd ``ctx``, and ``key``/``seed``: the
port's keys are int seeds or a bucket's ``LeafKeys``, host values).

This is a conservative approximation: closure variables are treated as
static, unresolvable aliases are skipped, and a value smuggled through a
container is invisible.  The checker proves the absence of the *patterns*;
the card's launch counts and build listener prove the property at the
sampled configurations.
"""

import ast

from .core import (
    Finding,
    callee_name,
    callee_tail,
    dotted_name,
    enclosing_function,
    reachable_functions,
)

CHECKER = "retrace"

#: torch.func transforms whose function argument runs transformed
TRANSFORMS = frozenset({"vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev", "jacfwd"})

#: roots under which a transform's name is torch's (``torch.autograd.grad``
#: takes tensors, not a function, and is no transform)
TRANSFORM_ROOTS = frozenset({"torch", "func", "torch.func"})

#: functions other modules run under vmap, by package directory: every
#: rule's entry points (the flat engine's bucketed leaf path, ``per_leaf``)
#: and the experiments' losses (the workers' ``vmap(grad_and_value(loss))``,
#: ``RobustEngine._worker_gradients``)
VMAPPED_ENTRIES = {
    "gars/": frozenset({"aggregate_block", "aggregate_block_and_participation", "_call_aggregate",
                        "worker_participation"}),
    "models/": frozenset({"loss"}),
}

#: ops/build entry points that compile (or load after compiling) a library
BUILDS = frozenset({"build_all", "library", "start_build"})

#: op registrations: a fresh registration per call is a fresh op
REGISTRATIONS = frozenset({"custom_op", "Library", "register_fake", "register_vmap"})

#: attribute projections of a tensor that are static under a transform
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad"})

#: methods whose result on a tensor is static under a transform
STATIC_METHODS = frozenset({"dim", "numel", "size", "is_contiguous", "element_size", "is_floating_point"})

#: calls whose result on a transformed argument is static
STATIC_CALLS = frozenset({"len", "isinstance", "type", "id", "repr", "getattr", "hasattr"})

HOST_SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_SYNC_NUMPY = frozenset({"asarray", "array", "copy", "ascontiguousarray"})
NUMPY_ROOTS = frozenset({"np", "numpy", "onp"})

#: parameter names that carry no tensor in the port
STATIC_PARAM_NAMES = frozenset({"self", "cls", "cfg", "config", "axis", "axis_name", "info", "in_dims",
                                "key", "seed", "ctx", "rule"})


def _names_transform(node):
    """True when the expression ``node`` names a torch.func transform: bare,
    as ``from torch.func import vmap`` binds it, or under a torch root."""
    name = dotted_name(node)
    if name is None:
        return False
    base, _, tail = name.rpartition(".")
    return tail in TRANSFORMS and (not base or base in TRANSFORM_ROOTS)


def _decorator_transforms(dec):
    if isinstance(dec, ast.Call):
        if callee_tail(dec) == "partial":
            return any(_names_transform(arg) for arg in dec.args)
        return _names_transform(dec.func)
    return _names_transform(dec)


def _vmap_rule_statics(cls):
    """The static methods of an ``autograd.Function`` class that sets
    ``generate_vmap_rule = True`` (vmap runs them under the transform)."""
    generates = any(
        isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Constant) and stmt.value.value is True
        and any(isinstance(t, ast.Name) and t.id == "generate_vmap_rule" for t in stmt.targets)
        for stmt in cls.body)
    return [stmt for stmt in cls.body if generates and isinstance(stmt, ast.FunctionDef)
            and any(dotted_name(dec) == "staticmethod" for dec in stmt.decorator_list)]


def _functions_by_name(module):
    table = {}
    for func in module.functions():
        table.setdefault(func.name, []).append(func)
    return table


def _resolve_def(module, by_name, name, site):
    """The def ``name`` denotes at ``site``: one in the same lexical function,
    else the first of that name in the module."""
    caller = enclosing_function(module, site)
    candidates = by_name.get(name, [])
    for cand in candidates:
        if caller is not None and enclosing_function(module, cand) is caller:
            return cand
    return candidates[0] if candidates else None


def _alias_target(module, name, site):
    """The def name a one-hop alias ``name = def`` / ``name = partial(def, ...)``
    binds in the function enclosing ``site`` (or the module), else None."""
    scope = enclosing_function(module, site) or module.tree
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == name for t in node.targets):
            continue
        value = node.value
        if isinstance(value, ast.Call) and callee_tail(value) == "partial" and value.args:
            value = value.args[0]
        if isinstance(value, ast.Name):
            return value.id
    return None


def find_transformed_functions(module):
    """The function defs that run under a torch.func transform."""
    by_name = _functions_by_name(module)
    traced = []

    def mark(func):
        if func is not None and not any(func is f for f in traced):
            traced.append(func)

    for func in module.functions():
        if any(_decorator_transforms(dec) for dec in func.decorator_list):
            mark(func)
        if any(module.path.startswith(prefix) and func.name in names for prefix, names in VMAPPED_ENTRIES.items()):
            mark(func)

    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            for method in _vmap_rule_statics(node):
                mark(method)
        if not isinstance(node, ast.Call):
            continue
        if _names_transform(node.func):
            args = list(node.args) + [kw.value for kw in node.keywords]
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "register_vmap":
            args = list(node.args[:1])
        else:
            continue
        for arg in args:
            if isinstance(arg, ast.Name):
                target = _resolve_def(module, by_name, arg.id, node)
                if target is None:
                    alias = _alias_target(module, arg.id, node)
                    target = None if alias is None else _resolve_def(module, by_name, alias, node)
                mark(target)
            elif isinstance(arg, ast.Lambda):
                for call in ast.walk(arg.body):
                    if isinstance(call, ast.Call) and isinstance(call.func, ast.Name):
                        mark(_resolve_def(module, by_name, call.func.id, node))

    changed = True
    while changed:
        changed = False
        for func in module.functions():
            if any(func is f for f in traced):
                continue
            parent = enclosing_function(module, func)
            while parent is not None:
                if any(parent is f for f in traced):
                    mark(func)
                    changed = True
                    break
                parent = enclosing_function(module, parent)

    return reachable_functions(module, traced)


# --------------------------------------------------------------------- #
# Transformed-value dataflow inside one transformed function


def _names_in(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _assigned_names(target):
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


def traced_names(func):
    """Parameter-derived names inside ``func`` (forward propagation through
    :func:`is_dynamic`; a name assigned from a static projection like ``n, d
    = x.shape`` stays static; no kill -- once transformed, always suspect)."""
    args = func.args
    names = {
        a.arg
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        if a.arg not in STATIC_PARAM_NAMES and not a.arg.endswith("_axis")
    }
    for extra in (args.vararg, args.kwarg):
        if extra is not None:
            names.add(extra.arg)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(func):
            value = None
            targets = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.For):
                value, targets = node.iter, [node.target]
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            if value is None:
                continue
            if is_dynamic(value, names):
                for target in targets:
                    new = _assigned_names(target) - names
                    if new:
                        names |= new
                        changed = True
    return names


def is_dynamic(expr, traced):
    """True when ``expr`` reads a transformed name OUTSIDE a static projection."""

    def walk(node):
        if isinstance(node, ast.Name):
            return node.id in traced
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return walk(node.value)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and node.func.attr in STATIC_METHODS:
                return False
            if callee_tail(node) in STATIC_CALLS:
                return False
            return any(walk(child) for child in list(node.args)
                       + [kw.value for kw in node.keywords]) or walk(node.func)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(walk(c) for c in [node.left] + node.comparators)
        if isinstance(node, ast.Subscript):
            return walk(node.value) or walk(node.slice)
        return any(walk(child) for child in ast.iter_child_nodes(node))

    return walk(expr)


def _in_loop(module, node, stop_at):
    """True when ``node`` sits inside a for/while loop body below ``stop_at``."""
    cur = module.parent(node)
    while cur is not None and cur is not stop_at:
        if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
            return True
        cur = module.parent(cur)
    return False


def _build_aliases(module):
    """(module aliases of ``ops/build``, bare names imported from it)."""
    modules, functions = set(), set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ImportFrom):
            source = node.module or ""
            for alias in node.names:
                if alias.name == "build" and (source in ("", "ops") or source.endswith(".ops")):
                    modules.add(alias.asname or "build")
                if alias.name in BUILDS and (source == "build" or source.endswith(".build")):
                    functions.add(alias.asname or alias.name)
    if module.path == "ops/build.py":
        functions |= BUILDS
    return modules, functions


def _rebuild_site(call, build_aliases):
    """The symbol of a kernel build or an op registration, else None."""
    name = callee_name(call)
    if name is None:
        return None
    modules, functions = build_aliases
    base, _, tail = name.rpartition(".")
    if (not base and name in functions) or (tail in BUILDS and base in modules):
        return name
    if tail in REGISTRATIONS and base:
        if tail in ("register_fake", "register_vmap"):
            return tail  # a method of any op object
        if base in ("torch.library", "library"):
            return name
    return None


def check_module(module):
    findings = []
    traced_funcs = find_transformed_functions(module)
    aliases = _build_aliases(module)

    # RT001: every build or registration site in a loop or a transformed scope
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        symbol = _rebuild_site(node, aliases)
        if symbol is None:
            continue
        func = enclosing_function(module, node)
        scope = module.qualname(func) if func is not None else ""
        if _in_loop(module, node, func):
            findings.append(Finding(
                CHECKER, "RT001", module.path, node.lineno, scope, symbol,
                "%s(...) inside a loop body: a kernel build or op registration per iteration -- "
                "build and register once, before the first step" % symbol,
            ))
        if func is not None and any(func is f for f in traced_funcs):
            findings.append(Finding(
                CHECKER, "RT001", module.path, node.lineno, scope, symbol + ".traced",
                "%s(...) inside a transformed scope: built or registered again on every transformed "
                "call -- hoist it to import or build time" % symbol,
            ))

    # RT002 / RT003: inside each transformed function
    for func in traced_funcs:
        traced = traced_names(func)
        scope = module.qualname(func)

        def owned(node, func=func):
            return enclosing_function(module, node) is func

        for node in ast.walk(func):
            if not owned(node):
                continue
            if isinstance(node, ast.Call):
                tail = callee_tail(node)
                name = callee_name(node) or ""
                root = name.split(".", 1)[0]
                args = list(node.args) + [kw.value for kw in node.keywords]
                dynamic_arg = any(is_dynamic(a, traced) for a in args)
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in HOST_SYNC_METHODS
                    and not node.args
                    and is_dynamic(node.func.value, traced)
                ):
                    findings.append(Finding(
                        CHECKER, "RT002", module.path, node.lineno, scope, node.func.attr,
                        ".%s() on a transformed value reads it on the host: under vmap it raises, "
                        "on the card it stalls the stream" % node.func.attr,
                    ))
                elif tail in HOST_SYNC_BUILTINS and name == tail and dynamic_arg:
                    findings.append(Finding(
                        CHECKER, "RT002", module.path, node.lineno, scope, tail,
                        "%s() on a transformed value reads it on the host" % tail,
                    ))
                elif root in NUMPY_ROOTS and tail in HOST_SYNC_NUMPY and dynamic_arg:
                    findings.append(Finding(
                        CHECKER, "RT002", module.path, node.lineno, scope, name,
                        "%s() on a transformed value copies it to the host -- keep it a tensor" % name,
                    ))
                elif name in ("torch.cuda.synchronize", "cuda.synchronize"):
                    findings.append(Finding(
                        CHECKER, "RT002", module.path, node.lineno, scope, name,
                        "torch.cuda.synchronize() inside a transformed scope stalls the host on "
                        "every transformed call",
                    ))
            elif isinstance(node, (ast.If, ast.While)):
                if is_dynamic(node.test, traced):
                    culprits = sorted(_names_in(node.test) & traced)
                    findings.append(Finding(
                        CHECKER, "RT003", module.path, node.lineno, scope,
                        ",".join(culprits) or "test",
                        "Python %s on a transformed value: data-dependent control flow, which "
                        "vmap refuses -- use torch.where" % ("while" if isinstance(node, ast.While) else "if"),
                    ))
    return findings


def check(modules):
    findings = []
    for module in modules:
        findings.extend(check_module(module))
    return findings
