"""Serving tier of the port: the continuous-batching
:class:`OrderedServingEngine` (model-serving embodiment of the ordered-egress
problem)."""
from .engine import Completion, OrderedServingEngine, Request

__all__ = ["Completion", "OrderedServingEngine", "Request"]
