# Port copy of src/repro/analysis/guards.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Guarded-by lint (rules GB101–GB104).

Grammar (see docs/static-analysis.md):

``self.attr = ...  # guarded-by: self._lock``
    Every write to ``self.attr`` anywhere in the class must occur lexically
    inside ``with self._lock:`` (constructors are exempt — ``__init__`` runs
    before the object is shared).

``self.attr = ...  # guarded-by(rw): self._lock``
    Reads of ``self.attr`` must be under the lock too.

``def meth(self):  # holds: self._lock``
    The method body may assume the lock is held (its call sites are checked
    by the lock-graph pass, rule LK203).

``self.attr = ...  # lock-free: <why>``
    Documents a deliberately unguarded shared attribute; the pass records it
    but checks nothing (the justification is the point).

Writes are assignments (including tuple targets and ``del``/subscript
stores) plus calls of known mutating container methods (``append``, ``pop``,
``update``, ...) and ``heapq.heappush``/``heappop`` on the attribute.
The match is lexical: aliasing (``s = self.attr; s.append(...)``) is
invisible, so keep guarded state un-aliased.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding, SourceModule, norm_expr

_MUTATORS = {
    "append", "extend", "insert", "pop", "popleft", "appendleft",
    "remove", "clear", "update", "setdefault", "add", "discard",
    "sort", "reverse",
}
_HEAP_FNS = {"heappush", "heappop", "heappushpop", "heapreplace"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"``; anything else -> None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _flat_targets(target: ast.AST) -> List[ast.AST]:
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[ast.AST] = []
        for e in target.elts:
            out.extend(_flat_targets(e))
        return out
    if isinstance(target, ast.Starred):
        return _flat_targets(target.value)
    return [target]


def _target_attr(node: ast.AST) -> Optional[str]:
    """The ``self.X`` an assignment/delete target mutates, if any
    (``self.X = ...``, ``self.X[i] = ...``, ``del self.X[...]``)."""
    attr = _self_attr(node)
    if attr is not None:
        return attr
    if isinstance(node, ast.Subscript):
        return _self_attr(node.value)
    return None


def _stmt_writes(st: ast.stmt) -> List[Tuple[str, int]]:
    """Attributes a simple statement writes, as ``(attr, line)`` pairs."""
    out: List[Tuple[str, int]] = []
    targets: List[ast.AST] = []
    if isinstance(st, ast.Assign):
        for t in st.targets:
            targets.extend(_flat_targets(t))
    elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
        targets.append(st.target)
    elif isinstance(st, ast.Delete):
        targets.extend(st.targets)
    for t in targets:
        attr = _target_attr(t)
        if attr is not None:
            out.append((attr, t.lineno))
    for node in ast.walk(st):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            attr = _self_attr(fn.value)
            if attr is not None:
                out.append((attr, node.lineno))
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if name in _HEAP_FNS and node.args:
            attr = _self_attr(node.args[0])
            if attr is not None:
                out.append((attr, node.lineno))
    return out


def _stmt_reads(st: ast.AST) -> List[Tuple[str, int]]:
    """``self.X`` loads inside a statement/expression, as (attr, line)."""
    out = []
    for node in ast.walk(st):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Load)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            out.append((node.attr, node.lineno))
    return out


def _with_exprs(st: ast.stmt) -> List[str]:
    """Normalized lock expressions a ``with`` statement acquires."""
    out = []
    for item in st.items:
        expr = item.context_expr
        if isinstance(expr, (ast.Name, ast.Attribute)):
            out.append(norm_expr(ast.unparse(expr)))
    return out


class _ClassChecker:
    """Checks one class body against its guarded-by annotations."""

    def __init__(self, mod: SourceModule, cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        self.findings: List[Finding] = []
        self.claimed_lines: Set[int] = set()
        # attr -> (mode, lock expr, declaration line)
        self.annotated: Dict[str, Tuple[str, str, int]] = {}
        self.acquired: Set[str] = set()
        self._discover()

    # ---------------------------------------------------------- discovery
    def _discover(self) -> None:
        span = range(self.cls.lineno, (self.cls.end_lineno or self.cls.lineno) + 1)
        anno_lines = {ln: v for ln, v in self.mod.guarded.items() if ln in span}
        for node in ast.walk(self.cls):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                self.acquired.update(_with_exprs(node))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                held = self.mod.holds.get(node.lineno)
                if held:
                    self.acquired.add(held)
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    targets.extend(_flat_targets(t))
            elif isinstance(node, ast.AnnAssign):
                targets.append(node.target)
            for t in targets:
                attr = _self_attr(t)
                if attr is None or node.lineno not in anno_lines:
                    continue
                mode, lock = anno_lines[node.lineno]
                self.annotated[attr] = (mode, lock, node.lineno)
                self.claimed_lines.add(node.lineno)
        for attr, (_mode, lock, line) in sorted(self.annotated.items()):
            if lock not in self.acquired:
                self.findings.append(
                    Finding(
                        rule="GB103",
                        path=self.mod.path,
                        line=line,
                        scope=f"{self.cls.name}.{attr}",
                        message=f"guard {lock!r} is never acquired in "
                        f"{self.cls.name} (typo?)",
                    )
                )

    # ------------------------------------------------------------- checking
    def check(self) -> List[Finding]:
        """Run the write/read discipline check over every method."""
        if self.annotated:
            for node in self.cls.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node.name == "__init__":
                        continue  # constructor-exempt
                    held = frozenset(
                        h for h in [self.mod.holds.get(node.lineno)] if h
                    )
                    self._block(node.body, held, node.name)
        return self.findings

    def _block(self, stmts, held: frozenset, meth: str) -> None:
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                self._block(st.body, held | frozenset(_with_exprs(st)), meth)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # A nested def may run after the lock is released: check its
                # body as if no lock were held (conservative).
                self._block(st.body, frozenset(), meth)
            elif isinstance(st, ast.If):
                self._expr(st.test, held, meth)
                self._block(st.body, held, meth)
                self._block(st.orelse, held, meth)
            elif isinstance(st, ast.While):
                self._expr(st.test, held, meth)
                self._block(st.body, held, meth)
                self._block(st.orelse, held, meth)
            elif isinstance(st, ast.For):
                self._expr(st.iter, held, meth)
                self._block(st.body, held, meth)
                self._block(st.orelse, held, meth)
            elif isinstance(st, ast.Try):
                self._block(st.body, held, meth)
                for h in st.handlers:
                    self._block(h.body, held, meth)
                self._block(st.orelse, held, meth)
                self._block(st.finalbody, held, meth)
            else:
                self._simple(st, held, meth)

    def _simple(self, st: ast.stmt, held: frozenset, meth: str) -> None:
        for attr, line in _stmt_writes(st):
            info = self.annotated.get(attr)
            if info and info[1] not in held:
                self._report("GB101", attr, line, meth, info, "write")
        self._expr(st, held, meth)

    def _expr(self, node: ast.AST, held: frozenset, meth: str) -> None:
        for attr, line in _stmt_reads(node):
            info = self.annotated.get(attr)
            if info and info[0] == "rw" and info[1] not in held:
                self._report("GB102", attr, line, meth, info, "read")

    def _report(self, rule, attr, line, meth, info, verb) -> None:
        f = Finding(
            rule=rule,
            path=self.mod.path,
            line=line,
            scope=f"{self.cls.name}.{meth}",
            message=f"{verb} of self.{attr} outside 'with {info[1]}' "
            f"(declared guarded at line {info[2]})",
        )
        if f not in self.findings:
            self.findings.append(f)


def check_module(mod: SourceModule) -> List[Finding]:
    """Run the guarded-by lint over one parsed module."""
    findings: List[Finding] = []
    claimed: Set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            checker = _ClassChecker(mod, node)
            findings.extend(checker.check())
            claimed |= checker.claimed_lines
    for line in sorted(set(mod.guarded) - claimed):
        findings.append(
            Finding(
                rule="GB104",
                path=mod.path,
                line=line,
                scope="<module>",
                message="guarded-by comment is not attached to a "
                "'self.attr = ...' statement inside a class",
            )
        )
    return findings
