"""Physical-operator selection for the local Indexed DataFrame.

This slice carries the two rules a single-partition frame uses, with the
reason strings of the JAX package's planner (core/planner.py):

* L1 — a point lookup on one partition runs the local fused probe;
* J1 — an equi-join with one partition as the build side runs the local
  indexed join.

The distribution rules (L2-L4, J2-J4), partition pruning (P1-P3) and the
relational rewrites come with the parts of the port that need them.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Physical:
    kind: str            # IndexedLookup | IndexedJoin
    reason: str
    node: Any
    children: tuple = ()
    meta: Any = None

    def explain(self, depth: int = 0) -> str:
        pad = "  " * depth
        out = f"{pad}{self.kind}  [{self.reason}]\n"
        for c in self.children:
            out += c.explain(depth + 1)
        return out


class Planner:
    """Physical-operator selector for a local table.  It has no knobs yet:
    the JAX planner's thresholds choose between distributed flavors."""

    def physical_lookup(self, table, num_queries: int,
                        keys=None) -> Physical:
        """Physical operator for a point lookup over ``table`` at the
        given query-batch size (rule L1)."""
        return Physical("IndexedLookup",
                        "L1: single partition -> local fused probe "
                        "[est_fanout=1x]",
                        table)

    def physical_join(self, table, probe_rows: int, keys=None) -> Physical:
        """Physical operator for an indexed equi-join with ``table`` as
        the build side (rule J1)."""
        return Physical("IndexedJoin",
                        "J1: single partition -> local indexed join "
                        "[est_fanout=1x]",
                        table)
