"""Concurrency lint: host threads never touch shared state unlocked, nor
meet the default group's collectives out of step.

Counterpart of ``aggregathor_tpu/analysis/concurrency.py`` (CC001, the same
algorithm), plus CC002, which has no JAX counterpart.  The port runs real
threads in production paths: the bounded-wait submission pool
(``parallel/bounded.py``, whose ``_dispatch_lock`` and ``_round_lock``
count as locks), the input ``ChunkPipeline`` and prefetcher
(``models/datasets.py``), the serving lanes, autoscaler, checkpoint
watcher, frontend and router (``serve/``), the live, fleet and checkpoint
writers (``obs/live.py``, ``obs/fleet.py``, ``obs/checkpoint.py``) and the
runner's and server's helper threads (``cli/runner.py``,
``cli/serve.py``).  The dynamic tests exercise each at one schedule; this
checker proves the *patterns* absent (or explicitly baselined with their
safety argument) package-wide.

Algorithm:

1. **Spawn sites**: every ``threading.Thread(target=X)``,
   ``threading.Timer(_, X)`` and ``<pool>.submit(X, ...)`` in the module.
   ``X`` resolves intra-module (bare names, nested defs, ``self.method``);
   unresolvable targets (stdlib callables like ``serve_forever``,
   ``np.take``) are skipped -- their bodies are not ours to lint.
2. **Reachability**: the transitive intra-module call closure from the
   spawn targets (``core.reachable_functions``) -- the set of functions
   that may execute on a non-main thread.
3. **CC001**: inside that set, an attribute write (``obj.attr = ...``,
   ``obj.attr += ...``, ``obj.attr[i] = ...``) whose base object is not
   function-local, not lexically inside a ``with <lock>`` block, and not
   in ``__init__`` (construction happens before the thread exists).
   Lock recognition is lexical: a token of the context expression's last
   segment is a lock word (``lock``, ``mutex``, ``cond``, ``sem``, ...).
4. **CC002** (trap ba): inside that set, a ``torch.distributed``
   collective (``all_reduce``, ``all_gather``, ``broadcast``, ``barrier``,
   ``send``/``recv``, a ``P2POp``, ...; through ``import
   torch.distributed as dist``, ``torch.distributed.X`` or ``from
   torch.distributed import X``) that names no ``group=`` keyword.  It
   runs on the default (world) group, whose collectives the main thread
   and every other rank issue in their own order: a thread's call meets
   them out of step and deadlocks or mixes payloads.  A submesh unit's
   collectives on a submission thread run on the submission's own groups
   (``mesh.submission_grid``), JAX's counterpart being a submesh's
   submission dispatched as a program of its own.  A lock does not help,
   so CC002 ignores locks.  A group passed by position is not seen: name it.

What a CC001 baseline entry must argue: why the write is safe --
single-writer with GIL-atomic reference assignment, an Event/queue
handshake ordering the read after the write, or monotonic telemetry where
staleness is tolerated.  "It has not crashed yet" is not an argument; an
empty justification is itself a finding (BL002).
"""

import ast
import re

from .core import (
    Finding,
    callee_name,
    callee_tail,
    dotted_name,
    enclosing_function,
    reachable_functions,
)

CHECKER = "concurrency"

#: torch.distributed calls that are collectives over a group (``group=``):
#: ``batch_isend_irecv`` takes ``P2POp``s, each of which names its group
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "gather", "gather_object", "scatter",
    "scatter_object_list", "send", "recv", "isend", "irecv", "P2POp",
})

LOCKISH = frozenset({
    "lock", "rlock", "mutex", "cond", "condition", "sem", "semaphore",
    "guard", "latch",
})


def _is_lockish(expr):
    """Last name segment of a with-context looks like a lock.

    Token match, not substring: the name is split on underscores and camel
    humps and a token must EQUAL a lock word (or end with ``lock``, for
    ``qlock``-style names) — ``assembler`` must not whitelist a block just
    because it contains ``sem``."""
    name = callee_name(expr) if isinstance(expr, ast.Call) else dotted_name(expr)
    if not name:
        return False
    tail = name.rsplit(".", 1)[-1]
    tokens = [t for t in re.split(r"_|(?<=[a-z0-9])(?=[A-Z])", tail) if t]
    return any(t.lower() in LOCKISH or t.lower().endswith("lock")
               for t in tokens)


def _spawn_targets(module):
    """Function defs handed to Thread(target=)/Timer/pool.submit."""
    targets = []

    def resolve(arg, site):
        """ALL function defs ``arg`` may denote (a ``self.X`` spawn in a
        module with several classes defining ``X`` must cover every one —
        the conservative over-approximation)."""
        if isinstance(arg, ast.Name):
            caller = enclosing_function(module, site)
            scope = caller
            while scope is not None:
                for node in ast.walk(scope):
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and node.name == arg.id:
                        return [node]
                scope = enclosing_function(module, scope)
            return [
                node for node in module.tree.body
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == arg.id
            ]
        if isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name) \
                and arg.value.id in ("self", "cls"):
            return [
                stmt
                for node in ast.walk(module.tree)
                if isinstance(node, ast.ClassDef)
                for stmt in node.body
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name == arg.attr
            ]
        return []

    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        tail = callee_tail(node)
        if tail in ("Thread", "Timer"):
            for kw in node.keywords:
                if kw.arg == "target":
                    targets.extend(resolve(kw.value, node))
            if tail == "Timer" and len(node.args) >= 2:
                targets.extend(resolve(node.args[1], node))
        elif tail == "submit" and node.args:
            targets.extend(resolve(node.args[0], node))
    return targets


def _attr_write_base(target):
    """(base-name, attr-symbol) of an attribute-write target, else None.

    ``self.x = _``        -> ("self", "x")
    ``pending.error = _`` -> ("pending", "error")
    ``self.buf[i] = _``   -> ("self", "buf[]")
    """
    if isinstance(target, ast.Subscript):
        inner = _attr_write_base(target.value)
        if inner is not None:
            return inner[0], inner[1] + "[]"
        if isinstance(target.value, ast.Name):
            return None  # plain local-subscript writes are the owner's call
        return None
    if isinstance(target, ast.Attribute):
        cur = target.value
        while isinstance(cur, ast.Attribute):
            cur = cur.value
        if isinstance(cur, ast.Name):
            return cur.id, target.attr
    return None


def _local_names(func):
    """Names bound by plain (non-attribute) assignment/for/with in ``func``
    — writes through them are writes to objects this function created or
    was handed privately ONLY when they never alias shared state; we treat
    params as shared (the spawn call passes shared objects in)."""
    created = set()
    params = {
        a.arg
        for a in list(func.args.posonlyargs) + list(func.args.args)
        + list(func.args.kwonlyargs)
    }

    def reads_shared(value):
        # an alias of shared state (``st = self.state``) is NOT private: a
        # one-line alias must not defeat the lint
        return any(
            isinstance(n, ast.Name) and n.id in ("self", "cls")
            for n in ast.walk(value)
        )

    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            if reads_shared(node.value):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    created.add(t.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    created.add(n.id)
        elif isinstance(node, ast.With):
            for item in node.items:
                if item.optional_vars is not None:
                    for n in ast.walk(item.optional_vars):
                        if isinstance(n, ast.Name):
                            created.add(n.id)
    return created - params - {"self", "cls"}


def _distributed_aliases(module):
    """(module aliases, function aliases) bound to ``torch.distributed`` and
    its collectives by the file's own imports."""
    module_aliases, function_aliases = {"torch.distributed"}, set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch.distributed" and alias.asname:
                    module_aliases.add(alias.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for alias in node.names:
                    if alias.name == "distributed":
                        module_aliases.add(alias.asname or "distributed")
            elif node.module == "torch.distributed":
                for alias in node.names:
                    if alias.name in COLLECTIVES:
                        function_aliases.add(alias.asname or alias.name)
    return module_aliases, function_aliases


def _collective(call, aliases):
    """The collective's name when ``call`` is a torch.distributed collective
    through the file's imports, else None."""
    module_aliases, function_aliases = aliases
    name = callee_name(call)
    if name is None:
        return None
    if name in function_aliases:
        return name
    base, _, tail = name.rpartition(".")
    return tail if tail in COLLECTIVES and base in module_aliases else None


def check_module(module):
    findings = []
    spawned = _spawn_targets(module)
    if not spawned:
        return findings
    aliases = _distributed_aliases(module)
    for func in reachable_functions(module, spawned):
        if func.name == "__init__":
            continue
        scope = module.qualname(func)
        locals_ = _local_names(func)
        for node in ast.walk(func):
            if isinstance(node, ast.Call) and enclosing_function(module, node) is func:
                collective = _collective(node, aliases)
                if collective is not None and not any(kw.arg == "group" for kw in node.keywords):
                    findings.append(Finding(
                        CHECKER, "CC002", module.path, node.lineno, scope, collective,
                        "torch.distributed.%s on a thread-reachable path names no group=: it runs on "
                        "the default group, whose collectives the main thread and the other ranks "
                        "issue in their own order -- give the thread a group of its own" % collective,
                    ))

        def lock_depth(node, func=func):
            depth = 0
            cur = module.parent(node)
            while cur is not None and cur is not func:
                if isinstance(cur, (ast.With, ast.AsyncWith)):
                    if any(_is_lockish(item.context_expr) for item in cur.items):
                        depth += 1
                cur = module.parent(cur)
            return depth

        for node in ast.walk(func):
            if enclosing_function(module, node) is not func:
                continue  # nested defs are checked via their own reachability
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]  # a bare annotation writes nothing
            for target in targets:
                base = _attr_write_base(target)
                if base is None:
                    continue
                base_name, symbol = base
                if base_name in locals_:
                    continue  # object this function created itself
                if lock_depth(node) > 0:
                    continue
                findings.append(Finding(
                    CHECKER, "CC001", module.path, node.lineno, scope,
                    "%s.%s" % (base_name, symbol),
                    "unlocked write to %s.%s on a thread-reachable path: "
                    "hold the owning lock, or baseline with the safety "
                    "argument (single-writer handshake, GIL-atomic "
                    "reference, tolerated-staleness telemetry)"
                    % (base_name, symbol),
                ))
    return findings


def check(modules):
    findings = []
    for module in modules:
        findings.extend(check_module(module))
    return findings
