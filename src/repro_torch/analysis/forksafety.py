# Port copy of src/repro/analysis/forksafety.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Fork-safety lint (rules FS301–FS303).

The staged process backend (:mod:`repro_torch.core.procrun`) forks workers with
the ``fork`` start method: the child inherits a snapshot of the parent's
memory.  Two classes of bug follow:

- **FS301** — a module that forks (`...Process(...)` / ``os.fork``) must not
  create ``threading`` primitives: a thread does not survive the fork, and a
  lock held at fork time stays locked *forever* in the child.  Any use of
  the ``threading`` module (or names imported from it) in a forking module
  is flagged — the supervisor is designed single-threaded, keep it that way.
- **FS302** — shared-memory segments (``SharedMemory(create=True)`` or the
  :mod:`repro_torch.core.shm` ring classes built on it) must stay inside the
  unlink discipline: every class (or module-level function scope) that
  creates a segment must also call ``.unlink()`` somewhere, or the segment
  leaks into ``/dev/shm`` past process exit.  (Exactly one ``unlink`` per
  created name is the runtime rule; the lint checks the weaker static
  property that an unlink path exists at all.)
- **FS303** — a function registered as a signal handler
  (``signal.signal(SIG, handler)``) must not acquire locks: the handler can
  fire while the *same thread* already holds the lock mid-critical-section,
  and a non-reentrant acquire then deadlocks the process from the inside.
  Flagged inside handler bodies: ``.acquire()`` calls and ``with``-blocks
  over lock-ish objects (names matching ``lock``/``mutex``).  Handlers must
  stay lock-free — set a flag or raise, like
  :func:`repro_torch.core.procrun._sig_raise`.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set, Tuple

from .common import Finding, SourceModule

_SHM_CTORS = {"ShmSpscRing", "ShmReorderRing", "ExchangeRing"}


def _forks(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in ("Process", "fork"):
                return True
            if isinstance(fn, ast.Name) and fn.id == "Process":
                return True
    return False


def _threading_names(tree: ast.Module) -> Set[str]:
    """Names bound from ``threading`` by ``from threading import X``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "threading":
            for alias in node.names:
                out.add(alias.asname or alias.name)
    return out


def _creates_shm(call: ast.Call) -> Optional[str]:
    """The shm artifact a call creates, or None."""
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None
    )
    if name == "SharedMemory":
        for k in call.keywords:
            if (
                k.arg == "create"
                and isinstance(k.value, ast.Constant)
                and k.value.value is True
            ):
                return "SharedMemory(create=True)"
        return None  # attach-only: the creator owns the unlink
    if name in _SHM_CTORS:
        return name
    return None


_LOCKISH_RE = re.compile(r"lock|mutex", re.IGNORECASE)


def _signal_handlers(tree: ast.Module) -> Tuple[Set[str], List[ast.Lambda]]:
    """Handler names (and inline lambdas) registered via ``signal.signal``."""
    names: Set[str] = set()
    lambdas: List[ast.Lambda] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        fn = node.func
        is_register = (
            (isinstance(fn, ast.Attribute) and fn.attr == "signal")
            or (isinstance(fn, ast.Name) and fn.id == "signal")
        )
        if not is_register:
            continue
        handler = node.args[1]
        if isinstance(handler, ast.Name):
            names.add(handler.id)
        elif isinstance(handler, ast.Lambda):
            lambdas.append(handler)
    return names, lambdas


def _lockish_name(expr: ast.AST) -> Optional[str]:
    """The lock-ish identifier a ``with`` context expression names, if any."""
    if isinstance(expr, ast.Call):
        expr = expr.func  # with self._lock(): / with threading.Lock():
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    else:
        return None
    return name if _LOCKISH_RE.search(name) else None


def _lock_acquisitions(fn_node: ast.AST) -> List[Tuple[int, str]]:
    """(line, description) of every lock acquisition inside a handler."""
    hits: List[Tuple[int, str]] = []
    for node in ast.walk(fn_node):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            hits.append((node.lineno, ".acquire() call"))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = _lockish_name(item.context_expr)
                if name:
                    hits.append(
                        (item.context_expr.lineno, f"'with {name}:' block")
                    )
    return hits


def _scope_of(tree: ast.Module, lineno: int) -> str:
    """Qualified ``Class.method`` scope containing a line (best effort)."""
    best = "<module>"
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            end = node.end_lineno or node.lineno
            if node.lineno <= lineno <= end:
                if best == "<module>":
                    best = node.name
                else:
                    best = f"{best}.{node.name}"
    return best


def check_module(mod: SourceModule) -> List[Finding]:
    """Run the fork-safety lint over one parsed module."""
    findings: List[Finding] = []
    tree = mod.tree

    # FS301: threading primitives in a forking module.
    if _forks(tree):
        from_names = _threading_names(tree)
        for node in ast.walk(tree):
            hit = None
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "threading"
            ):
                hit = f"threading.{node.attr}"
            elif isinstance(node, ast.Name) and node.id in from_names:
                hit = node.id
            if hit:
                findings.append(
                    Finding(
                        rule="FS301",
                        path=mod.path,
                        line=node.lineno,
                        scope=_scope_of(tree, node.lineno),
                        message=f"{hit} used in a forking module: threads "
                        "don't survive fork and inherited locks stay "
                        "locked in the child",
                    )
                )

    # FS303: signal handlers must stay lock-free.
    handler_names, handler_lambdas = _signal_handlers(tree)
    handlers: List[ast.AST] = list(handler_lambdas)
    if handler_names:
        handlers.extend(
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name in handler_names
        )
    for fn_node in handlers:
        label = getattr(fn_node, "name", "<lambda>")
        for line, what in _lock_acquisitions(fn_node):
            findings.append(
                Finding(
                    rule="FS303",
                    path=mod.path,
                    line=line,
                    scope=_scope_of(tree, line),
                    message=f"{what} inside signal handler {label}: the "
                    "handler can interrupt the holder mid-critical-section "
                    "and deadlock; handlers must stay lock-free",
                )
            )

    # FS302: shm creation scopes must contain an unlink path.
    scopes: List[ast.AST] = [
        n for n in tree.body if isinstance(n, ast.ClassDef)
    ]
    module_level = [n for n in tree.body if not isinstance(n, ast.ClassDef)]
    for scope in scopes:
        creations = []
        has_unlink = False
        for node in ast.walk(scope):
            if isinstance(node, ast.Call):
                made = _creates_shm(node)
                if made:
                    creations.append((made, node.lineno))
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "unlink"
                ):
                    has_unlink = True
        if creations and not has_unlink:
            made, line = creations[0]
            findings.append(
                Finding(
                    rule="FS302",
                    path=mod.path,
                    line=line,
                    scope=scope.name,
                    message=f"{scope.name} creates {made} but never calls "
                    ".unlink(): the segment leaks past process exit",
                )
            )
    mod_creations = []
    mod_unlink = False
    for top in module_level:
        for node in ast.walk(top):
            if isinstance(node, ast.Call):
                made = _creates_shm(node)
                if made:
                    mod_creations.append((made, node.lineno))
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "unlink"
                ):
                    mod_unlink = True
    if mod_creations and not mod_unlink:
        made, line = mod_creations[0]
        findings.append(
            Finding(
                rule="FS302",
                path=mod.path,
                line=line,
                scope=_scope_of(tree, line),
                message=f"{made} created outside the unlink discipline "
                "(no module-level .unlink() call)",
            )
        )
    return findings
