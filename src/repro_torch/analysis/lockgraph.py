# Port copy of src/repro/analysis/lockgraph.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Interprocedural lock-order + blocking-call analysis (rules LK201–LK203).

Builds the lock-acquisition graph of a module: a node per lock identity
(``Class:self._lock`` — one node per *declaration site*, so an edge means
"some code path acquires B while holding A"), an edge for every nested
acquisition, including acquisitions reached through resolvable calls
(``self.method()`` within a class, module-level ``fn()`` within the module).

- **LK201** — a cycle in that graph is a potential deadlock (two code paths
  acquiring the same locks in opposite orders).
- **LK202** — a *blocking* operation while holding a lock: ``time.sleep``,
  pipe/queue ``recv``/``recv_bytes``, ``join``, ``wait``, a bare
  ``.acquire()`` (untracked release; blocking unless called with
  ``blocking=False``), an unbounded ``send_blocking`` ring push, or a
  reentrant downstream emit (``self._send_downstream`` / ``self.downstream``)
  — the exact shape of the PR 1 parking-buffer deadlock.  Detection is by
  method *name* (documented heuristic); resolvable calls are searched
  transitively, so a method that takes a lock and calls a helper that sleeps
  is still flagged.
- **LK203** — a call to a function annotated ``# holds: <lock>`` from a site
  that does not lexically hold that lock.

Dynamic calls (stored callables, subscripted targets) are not resolved;
cross-instance aliases of the same lock declaration share one graph node,
which over-approximates (a strict instance ordering cannot be expressed) —
suppress with a justification where the instance order is provably acyclic.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding, SourceModule, norm_expr

_BLOCKING_ATTRS = {
    "recv": "pipe/connection recv",
    "recv_bytes": "pipe/connection recv",
    "join": "thread/process join",
    "wait": "event/condition wait",
    "send_blocking": "unbounded ring push (spins until accepted)",
}
_REENTRANT_ATTRS = {
    "_send_downstream": "reentrant downstream emit",
    "downstream": "reentrant downstream emit",
}


@dataclass
class _Fn:
    """One function/method with the facts the graph needs."""

    qualname: str
    node: ast.AST
    cls: Optional[str]
    holds: Optional[str] = None  # lock id asserted held by '# holds:'
    # (lock id, line) acquired directly via `with`
    acquires: List[Tuple[str, int]] = field(default_factory=list)
    # (description, line) of direct blocking operations
    blocking: List[Tuple[str, int]] = field(default_factory=list)
    # resolvable callee qualnames with call lines
    calls: List[Tuple[str, int]] = field(default_factory=list)


def _lock_id(expr: ast.AST, cls: Optional[str]) -> Optional[str]:
    """Stable identity for a lock expression: scope-qualified source text."""
    if isinstance(expr, (ast.Name, ast.Attribute)):
        return f"{cls or '<module>'}:{norm_expr(ast.unparse(expr))}"
    return None


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted-name rendering of a call target."""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse failure
        return "<?>"


def _call_kw_false(call: ast.Call, kw: str) -> bool:
    """True if the call passes ``kw=False`` or a literal False first arg."""
    for k in call.keywords:
        if k.arg == kw and isinstance(k.value, ast.Constant) and k.value.value is False:
            return True
    if call.args and isinstance(call.args[0], ast.Constant):
        return call.args[0].value is False
    return False


def _blocking_desc(call: ast.Call) -> Optional[str]:
    """Blocking-op description for a call, or None (the name heuristic)."""
    fn = call.func
    dotted = _dotted(fn)
    if dotted == "time.sleep":
        return "time.sleep"
    if not isinstance(fn, ast.Attribute):
        return None
    base = fn.value
    if isinstance(base, ast.Constant):
        return None  # "sep".join(...) and friends
    if fn.attr == "join" and _dotted(base) in ("os.path", "posixpath", "ntpath"):
        return None
    if fn.attr == "acquire":
        if _call_kw_false(call, "blocking"):
            return None
        return "blocking acquire (untracked release)"
    if fn.attr in _BLOCKING_ATTRS:
        return _BLOCKING_ATTRS[fn.attr]
    if fn.attr in _REENTRANT_ATTRS:
        return _REENTRANT_ATTRS[fn.attr]
    return None


class _ModuleGraph:
    """Collects per-function facts, then runs the three checks."""

    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.fns: Dict[str, _Fn] = {}
        self.methods: Dict[str, Set[str]] = {}  # class -> method names
        self.edges: Dict[Tuple[str, str], int] = {}  # (from, to) -> line
        self.findings: List[Finding] = []
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect(node, None)
            elif isinstance(node, ast.ClassDef):
                self.methods[node.name] = set()
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.methods[node.name].add(sub.name)
                        self._collect(sub, node.name)

    # ------------------------------------------------------------ collection
    def _collect(self, node: ast.AST, cls: Optional[str]) -> None:
        qual = f"{cls}.{node.name}" if cls else node.name
        fn = _Fn(qualname=qual, node=node, cls=cls)
        held_expr = self.mod.holds.get(node.lineno)
        if held_expr:
            fn.holds = f"{cls or '<module>'}:{held_expr}"
        for sub in ast.walk(node):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    lid = _lock_id(item.context_expr, cls)
                    if lid:
                        fn.acquires.append((lid, sub.lineno))
            elif isinstance(sub, ast.Call):
                desc = _blocking_desc(sub)
                if desc:
                    fn.blocking.append((desc, sub.lineno))
                callee = self._resolve(sub.func, cls)
                if callee:
                    fn.calls.append((callee, sub.lineno))
        self.fns[qual] = fn

    def _resolve(self, func: ast.AST, cls: Optional[str]) -> Optional[str]:
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and cls is not None
            and func.attr in self.methods.get(cls, ())
        ):
            return f"{cls}.{func.attr}"
        if isinstance(func, ast.Name) and func.id in self.fns:
            return func.id
        return None

    # --------------------------------------------------------- transitivity
    def _transitive(self, qual: str, what: str, seen=None) -> List[Tuple[str, int]]:
        """Own + callee-reachable ``acquires`` or ``blocking`` facts."""
        seen = seen if seen is not None else set()
        if qual in seen or qual not in self.fns:
            return []
        seen.add(qual)
        fn = self.fns[qual]
        out = list(getattr(fn, what))
        for callee, line in fn.calls:
            for item, _l in self._transitive(callee, what, seen):
                out.append((f"{item} (via {callee})" if what == "blocking" else item,
                            line))
        return out

    # -------------------------------------------------------------- checking
    def run(self) -> List[Finding]:
        """Walk every function with lexical held-lock tracking."""
        for fn in self.fns.values():
            held = [fn.holds] if fn.holds else []
            self._walk(fn, fn.node.body, held)
        self._cycles()
        return self.findings

    def _walk(self, fn: _Fn, stmts, held: List[str]) -> None:
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                got = []
                for item in st.items:
                    lid = _lock_id(item.context_expr, fn.cls)
                    if lid:
                        for h in held + got:
                            self.edges.setdefault((h, lid), st.lineno)
                        got.append(lid)
                self._walk(fn, st.body, held + got)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(fn, st.body, [])  # closure may outlive the lock
            elif isinstance(st, (ast.If, ast.While)):
                self._calls_in(fn, st.test, held)
                self._walk(fn, st.body, held)
                self._walk(fn, st.orelse, held)
            elif isinstance(st, ast.For):
                self._calls_in(fn, st.iter, held)
                self._walk(fn, st.body, held)
                self._walk(fn, st.orelse, held)
            elif isinstance(st, ast.Try):
                self._walk(fn, st.body, held)
                for h in st.handlers:
                    self._walk(fn, h.body, held)
                self._walk(fn, st.orelse, held)
                self._walk(fn, st.finalbody, held)
            else:
                self._calls_in(fn, st, held)

    def _calls_in(self, fn: _Fn, node: ast.AST, held: List[str]) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            desc = _blocking_desc(sub)
            if desc and held:
                self._blocked(fn, desc, sub.lineno, held)
            callee = self._resolve(sub.func, fn.cls)
            if not callee:
                continue
            cfn = self.fns.get(callee)
            if cfn and cfn.holds and cfn.holds not in held:
                self.findings.append(
                    Finding(
                        rule="LK203",
                        path=self.mod.path,
                        line=sub.lineno,
                        scope=fn.qualname,
                        message=f"call to {callee}() requires holding "
                        f"{cfn.holds.split(':', 1)[1]} (declared '# holds:')",
                    )
                )
            if held:
                for lid, _l in self._transitive(callee, "acquires"):
                    for h in held:
                        self.edges.setdefault((h, lid), sub.lineno)
                for bdesc, _l in self._transitive(callee, "blocking"):
                    self._blocked(fn, bdesc, sub.lineno, held)

    def _blocked(self, fn: _Fn, desc: str, line: int, held: List[str]) -> None:
        locks = ", ".join(h.split(":", 1)[1] for h in held)
        f = Finding(
            rule="LK202",
            path=self.mod.path,
            line=line,
            scope=fn.qualname,
            message=f"{desc} while holding {locks}",
        )
        if f not in self.findings:
            self.findings.append(f)

    # ---------------------------------------------------------------- cycles
    def _cycles(self) -> None:
        graph: Dict[str, Set[str]] = {}
        for (a, b), _line in self.edges.items():
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        counter = [0]
        sccs: List[List[str]] = []

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            for w in sorted(graph[v]):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        for comp in sccs:
            cyclic = len(comp) > 1 or (
                comp[0] in graph[comp[0]] if comp else False
            )
            if not cyclic:
                continue
            comp = sorted(comp)
            line = min(
                l for (a, b), l in self.edges.items() if a in comp and b in comp
            )
            names = " -> ".join(c.split(":", 1)[1] + f" ({c.split(':', 1)[0]})"
                                for c in comp)
            self.findings.append(
                Finding(
                    rule="LK201",
                    path=self.mod.path,
                    line=line,
                    scope="cycle:" + "+".join(comp),
                    message=f"lock-order cycle: {names} -> (back)",
                )
            )


def check_module(mod: SourceModule) -> List[Finding]:
    """Run the lock-graph analysis over one parsed module."""
    return _ModuleGraph(mod).run()
