"""Plan-time ordering-safety checks of the port (``plancheck``, PV4xx).

Only the JAX-free ``plancheck`` module is copied from ``repro.analysis``;
the AST passes over the source tree stay with the JAX package.
"""
from .plancheck import CATALOG_VERSION, PlanViolation, verify_plan

__all__ = ["CATALOG_VERSION", "PlanViolation", "verify_plan"]
