"""Atomic operator vocabulary of the QueryDAG (paper §4.1)."""
from __future__ import annotations

import enum


class OpType(enum.IntEnum):
    """Atomic logical operators. The scheduler pools nodes by this type
    (plus input cardinality for the set ops, Eq. 8)."""

    EMBED = 0      # anchor entity -> initial state ("EmbedE" in Table 6)
    PROJECT = 1    # relational projection state x relation -> state
    INTERSECT = 2  # variable-cardinality set intersection
    UNION = 3      # variable-cardinality set union
    NEGATE = 4     # complement

    @property
    def has_relation(self) -> bool:
        return self is OpType.PROJECT

    @property
    def variadic(self) -> bool:
        return self in (OpType.INTERSECT, OpType.UNION)


# Types whose pooled kernels share parameters across every instance in a pool
# (theta_{tau*} in Eq. 5).
POOLED_TYPES = tuple(OpType)
