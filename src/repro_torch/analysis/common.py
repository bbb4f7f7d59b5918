# Port copy of src/repro/analysis/common.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""Shared infrastructure for the static-analysis passes.

The passes (:mod:`.guards`, :mod:`.lockgraph`, :mod:`.forksafety`) are
pure-stdlib ``ast`` walks over the ``repro_torch.core`` sources.  This module owns
everything they share:

- the source-comment annotation grammar (``# guarded-by:``, ``# lock-free:``,
  ``# holds:``) and the suppression grammar (``# analysis: ignore[RULE]: why``),
- the :class:`Finding` record and its stable baseline key,
- the per-file parse bundle (:class:`SourceModule`) handed to each pass,
- the driver (:func:`analyze_paths`) that runs every pass, applies
  suppressions, and emits the suppression-hygiene findings (AN001/AN002),
- the committed-baseline load/diff used by ``--check``.

Rule IDs are grouped by pass: ``GB1xx`` guards, ``LK2xx`` lock graph,
``FS3xx`` fork safety, ``PV4xx`` plan verification (:mod:`.plancheck`),
``AN0xx`` annotation/suppression hygiene.  docs/static-analysis.md is the
user-facing catalog; keep the two in sync.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------- rules
RULES: Dict[str, str] = {
    "GB101": "write to a guarded-by attribute outside its lock",
    "GB102": "read of a guarded-by(rw) attribute outside its lock",
    "GB103": "guarded-by names a lock never acquired in the class",
    "GB104": "malformed or unattached annotation comment",
    "LK201": "lock-acquisition cycle (potential deadlock)",
    "LK202": "blocking operation while holding a lock",
    "LK203": "call to a '# holds:' function without holding its lock",
    "FS301": "threading primitive in a module that forks workers",
    "FS302": "shared-memory creation without an unlink discipline",
    "FS303": "lock acquisition inside a signal handler",
    "AN001": "suppression without a justification",
    "AN002": "suppression that matches no finding",
    "PV401": "stateful stage planned with width > 1",
    "PV402": "keyed stage width exceeds its partition count",
    "PV403": "reorder-ring capacity cannot cover the publish span",
    "PV404": "elastic headroom below the active stage width",
    "PV405": "parallel stage without a reorder ring to drain through",
    "PV406": "operator parallelism cap inconsistent with its kind",
    "PV407": "checkpoint geometry inconsistent with the stage layout",
    "PV408": "traffic-elasticity policy geometry unsatisfiable",
}


@dataclass(frozen=True)
class Finding:
    """One analysis finding, keyed stably for the baseline file.

    ``scope`` is the enclosing ``Class.method`` (or ``<module>``) so the
    baseline key survives unrelated line churn; ``line`` is only for the
    human-facing report.
    """

    rule: str
    path: str  # repo-relative posix path
    line: int
    scope: str
    message: str

    def key(self) -> str:
        """Line-number-free identity used by the committed baseline."""
        return f"{self.rule}:{self.path}:{self.scope}"

    def render(self) -> str:
        """One-line human-readable report form."""
        return f"{self.path}:{self.line}: {self.rule} [{self.scope}] {self.message}"

    def to_dict(self) -> dict:
        """JSON-able form (``--json`` report rows and baseline entries)."""
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
        }


# --------------------------------------------------------------- annotations
_GUARDED_RE = re.compile(r"#\s*guarded-by(\((?P<mode>rw)\))?:\s*(?P<expr>[^#]+)")
_LOCKFREE_RE = re.compile(r"#\s*lock-free:\s*(?P<why>\S.*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*(?P<expr>[^#]+)")
_IGNORE_RE = re.compile(
    r"#\s*analysis:\s*ignore\[(?P<rules>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)\]"
    r"(?P<rest>.*)"
)


def norm_expr(text: str) -> str:
    """Normalize a lock expression for textual comparison (strip spaces)."""
    return re.sub(r"\s+", "", text)


@dataclass
class Suppression:
    """One ``# analysis: ignore[RULE,...]: justification`` comment."""

    line: int
    rules: Set[str]
    justification: str
    used: bool = False

    @property
    def justified(self) -> bool:
        """A justification must carry real prose after the rule list."""
        return bool(self.justification.strip(" :—-–"))


@dataclass
class SourceModule:
    """A parsed source file plus its line-level annotation side tables."""

    path: str  # repo-relative posix path
    abspath: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    # line -> (attr-annotation mode, normalized lock expr): "w" or "rw"
    guarded: Dict[int, Tuple[str, str]] = field(default_factory=dict)
    # line -> justification text of a '# lock-free:' declaration
    lock_free: Dict[int, str] = field(default_factory=dict)
    # line -> normalized lock expr of a '# holds:' function contract
    holds: Dict[int, str] = field(default_factory=dict)
    suppressions: List[Suppression] = field(default_factory=list)

    @classmethod
    def parse(cls, abspath: str, relpath: str) -> "SourceModule":
        """Read + parse one file and extract its annotation comments."""
        with open(abspath, "r", encoding="utf-8") as f:
            source = f.read()
        mod = cls(
            path=relpath.replace(os.sep, "/"),
            abspath=abspath,
            source=source,
            tree=ast.parse(source, filename=relpath),
            lines=source.splitlines(),
        )
        for i, text in enumerate(mod.lines, start=1):
            if "#" not in text:
                continue
            m = _GUARDED_RE.search(text)
            if m:
                mod.guarded[i] = (m.group("mode") or "w", norm_expr(m.group("expr")))
            m = _LOCKFREE_RE.search(text)
            if m:
                mod.lock_free[i] = m.group("why").strip()
            m = _HOLDS_RE.search(text)
            if m:
                mod.holds[i] = norm_expr(m.group("expr"))
            m = _IGNORE_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group("rules").split(",")}
                mod.suppressions.append(
                    Suppression(line=i, rules=rules, justification=m.group("rest"))
                )
        return mod

    def suppression_for(self, finding: Finding) -> Optional[Suppression]:
        """The suppression covering ``finding``, if any.

        A suppression applies to findings on its own line and on the line
        directly below it (standalone-comment placement)."""
        for sup in self.suppressions:
            if finding.rule in sup.rules and finding.line in (sup.line, sup.line + 1):
                return sup
        return None


# ------------------------------------------------------------------- driver
_DEFAULT_TARGET = os.path.join("src", "repro_torch", "core")


def iter_py_files(paths: Sequence[str], root: str) -> List[Tuple[str, str]]:
    """Expand files/directories into ``(abspath, relpath)`` python sources."""
    out: List[Tuple[str, str]] = []
    for p in paths:
        ab = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(ab):
            for dirpath, _dirs, files in sorted(os.walk(ab)):
                for f in sorted(files):
                    if f.endswith(".py"):
                        full = os.path.join(dirpath, f)
                        out.append((full, os.path.relpath(full, root)))
        elif ab.endswith(".py"):
            out.append((ab, os.path.relpath(ab, root)))
        else:
            raise FileNotFoundError(f"not a python file or directory: {p}")
    return out


def analyze_paths(
    paths: Optional[Sequence[str]] = None, root: Optional[str] = None
) -> List[Finding]:
    """Run every pass over ``paths`` (default: ``src/repro_torch/core``).

    Applies suppressions (a justified — or merely present — suppression hides
    its finding; an unjustified one additionally raises AN001) and emits
    AN002 for suppressions that matched nothing.  Returns findings sorted by
    (path, line, rule).
    """
    from . import forksafety, guards, lockgraph

    root = root or os.getcwd()
    files = iter_py_files(paths or [_DEFAULT_TARGET], root)
    findings: List[Finding] = []
    for abspath, relpath in files:
        mod = SourceModule.parse(abspath, relpath)
        raw: List[Finding] = []
        raw.extend(guards.check_module(mod))
        raw.extend(lockgraph.check_module(mod))
        raw.extend(forksafety.check_module(mod))
        for f in raw:
            sup = mod.suppression_for(f)
            if sup is None:
                findings.append(f)
                continue
            sup.used = True
        for sup in mod.suppressions:
            if not sup.justified:
                findings.append(
                    Finding(
                        rule="AN001",
                        path=mod.path,
                        line=sup.line,
                        scope=f"ignore[{','.join(sorted(sup.rules))}]",
                        message="suppression needs a justification: "
                        "'# analysis: ignore[RULE]: why this is safe'",
                    )
                )
            elif not sup.used:
                findings.append(
                    Finding(
                        rule="AN002",
                        path=mod.path,
                        line=sup.line,
                        scope=f"ignore[{','.join(sorted(sup.rules))}]",
                        message="suppression matches no finding; delete it",
                    )
                )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ----------------------------------------------------------------- baseline
def load_baseline(path: str) -> Set[str]:
    """Read the committed baseline file into a set of finding keys."""
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != 1:
        raise ValueError(f"unknown baseline version {data.get('version')!r}")
    return {e["key"] for e in data.get("findings", [])}


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Write the grandfathered-findings baseline for ``--check`` runs."""
    entries = sorted(
        {f.key(): {"key": f.key(), "message": f.message} for f in findings}.values(),
        key=lambda e: e["key"],
    )
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=2, sort_keys=True)
        f.write("\n")


def diff_baseline(
    findings: Sequence[Finding], baseline: Set[str]
) -> Tuple[List[Finding], Set[str]]:
    """Split findings into (new-vs-baseline, stale baseline keys)."""
    seen = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    stale = {k for k in baseline if k not in seen}
    return new, stale
