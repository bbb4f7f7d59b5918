"""The partition spec type of the port's sharding layer (the counterpart of
``jax.sharding.PartitionSpec``), apart from the rules so that the parameter
definitions (``models/common.py``) can name their specs."""
from __future__ import annotations


class PartitionSpec(tuple):
    """Per tensor dim: ``None``, a mesh dim name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


__all__ = ["P", "PartitionSpec"]
