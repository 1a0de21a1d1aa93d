"""Journal-event checker: every ``emit`` names a declared event type.

Counterpart of ``aggregathor_tpu/analysis/events_check.py``, over the
port's own registry (``obs/events.py``: ``EVENT_TYPES`` and
``ACTION_EVENT_TYPES``, the JAX package's whole catalog).  The causal run
journal (``obs/events.py``) is only a timeline if every
event type is DECLARED in its schema registry -- an undeclared emit would
raise at the moment the decision it records fires (the worst possible
time), and a dynamically-computed type name cannot be validated at all.
Runtime validation catches the configured paths; this checker proves the
property over the WHOLE package:

- **EV001** -- a resolved journal ``emit(...)`` call whose event type is
  (a) a string literal NOT declared in ``obs.events.EVENT_TYPES``, (b) not
  a string literal at all (unverifiable statically), or (c) missing.
- **EV002** -- a resolved journal ``emit(...)`` of an ACTION event type
  (``obs.events.ACTION_EVENT_TYPES`` -- restarts, retunes, rollbacks,
  retries, exclusions: the events that CHANGE the fleet) without an
  explicit ``cause=`` keyword.  ``cause=None`` is legal -- some actions
  genuinely have no journal-event trigger (a liveness restart's evidence
  is the ABSENCE of scrapes) -- but the author must SAY so at the emit
  site; an action event silently minted without the kwarg is exactly how
  orphan actions (obs/causal.py) enter a postmortem.

Resolution is conservative and import-driven: a call counts as a journal
emit only when its callee resolves to the events module through the file's
own imports (``from ..obs import events; events.emit(...)``,
``from ..obs import events as obs_events``, ``from ..obs.events import
emit``, or the absolute ``aggregathor_tpu_torch.obs.events``) -- other
``.emit`` attributes (asyncio, user classes) are never convicted.  The
implementation module itself (``obs/events.py``) is excluded: its
``Journal.emit`` body necessarily handles the type as a variable.
"""

import ast

from .core import Finding

CHECKER = "events"

#: files whose emit machinery IS the implementation under test
EXCLUDED_PATHS = ("obs/events.py",)


def _emit_aliases(module):
    """(module_aliases, function_aliases) bound to obs.events / its emit."""
    module_aliases, function_aliases = set(), set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ImportFrom):
            source = node.module or ""
            if source == "obs" or source.endswith(".obs") or (
                source == "" and node.level  # "from . import events" in obs/
                and module.path.startswith("obs/")
            ):
                for alias in node.names:
                    if alias.name == "events":
                        module_aliases.add(alias.asname or "events")
            if source == "obs.events" or source.endswith(".obs.events") or (
                source == "events" and module.path.startswith("obs/")
            ):
                for alias in node.names:
                    if alias.name == "emit":
                        function_aliases.add(alias.asname or "emit")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("obs.events"):
                    module_aliases.add(alias.asname or alias.name)
    return module_aliases, function_aliases


def _is_events_emit(call, module_aliases, function_aliases):
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in function_aliases
    if isinstance(func, ast.Attribute) and func.attr == "emit":
        parts = []
        node = func.value
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            dotted = ".".join(reversed(parts))
            return dotted in module_aliases
    return False


def _declared_types():
    from ..obs.events import EVENT_TYPES

    return EVENT_TYPES


def _action_types():
    from ..obs.events import ACTION_EVENT_TYPES

    return ACTION_EVENT_TYPES


def check(modules):
    """Run EV001/EV002 over parsed modules; returns Finding records."""
    declared = _declared_types()
    actions = _action_types()
    findings = []
    for module in modules:
        if module.path in EXCLUDED_PATHS:
            continue
        module_aliases, function_aliases = _emit_aliases(module)
        if not module_aliases and not function_aliases:
            continue
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if not _is_events_emit(node, module_aliases, function_aliases):
                continue
            enclosing = _enclosing_def(module, node)
            scope = module.qualname(enclosing) if enclosing is not None else ""
            if not node.args:
                findings.append(Finding(
                    checker=CHECKER, code="EV001", path=module.path,
                    line=node.lineno, scope=scope, symbol="<missing>",
                    message="journal emit without an event type argument",
                ))
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                findings.append(Finding(
                    checker=CHECKER, code="EV001", path=module.path,
                    line=node.lineno, scope=scope, symbol="<dynamic>",
                    message="journal emit with a non-literal event type "
                            "cannot be verified against the schema registry",
                ))
                continue
            if first.value not in declared:
                findings.append(Finding(
                    checker=CHECKER, code="EV001", path=module.path,
                    line=node.lineno, scope=scope, symbol=first.value,
                    message="journal emit of UNDECLARED event type %r "
                            "(declare it in obs.events.EVENT_TYPES)"
                            % first.value,
                ))
                continue
            if first.value in actions and not any(
                    kw.arg == "cause" for kw in node.keywords):
                findings.append(Finding(
                    checker=CHECKER, code="EV002", path=module.path,
                    line=node.lineno, scope=scope, symbol=first.value,
                    message="action event %r emitted without an explicit "
                            "cause= keyword (pass cause=None if no journal "
                            "event triggered it -- the causal plane wants "
                            "the author to say so)" % first.value,
                ))
    return findings


def _enclosing_def(module, node):
    parent = module.parent(node)
    while parent is not None:
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            return parent
        parent = module.parent(parent)
    return None
