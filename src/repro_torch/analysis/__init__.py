"""Concurrency invariant checker of the port, over ``repro_torch.core``.

The port's copies of the JAX package's three AST pass families (see
docs/static-analysis.md for the annotation grammar and the rule catalog):

- :mod:`.guards` — ``# guarded-by:`` lock-discipline lint (GB1xx),
- :mod:`.lockgraph` — interprocedural lock-order + blocking-call analysis
  (LK2xx),
- :mod:`.forksafety` — fork/shared-memory hygiene for the process backend
  (FS3xx),

plus :mod:`.plancheck` (PV4xx), the plan-time ordering-safety catalog behind
:meth:`repro_torch.core.api.PhysicalPlan.verify`.

Run it: ``python -m repro_torch.analysis [--check] [--json] [paths...]``.
With no paths it reads ``src/repro_torch/core``; ``--check`` gates on the
root's ``ANALYSIS_BASELINE.json``: new findings fail.
"""
from .common import (
    RULES,
    Finding,
    SourceModule,
    analyze_paths,
    diff_baseline,
    load_baseline,
    write_baseline,
)
from .plancheck import CATALOG_VERSION, PlanViolation, verify_plan

__all__ = [
    "RULES",
    "Finding",
    "SourceModule",
    "analyze_paths",
    "diff_baseline",
    "load_baseline",
    "write_baseline",
    "CATALOG_VERSION",
    "PlanViolation",
    "verify_plan",
]
