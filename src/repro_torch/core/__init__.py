"""core — the Indexed DataFrame in PyTorch, module for module as in the
JAX package's ``repro.core``:

  pointers.py   flat int32 row pointers
  hashing.py    bucket hash (bit-identical to the JAX package and the
                kernel) and the host-side string hashes
  hashindex.py  dense bucketized hash index: bulk build, probe, chain walk
  schema.py     fixed-width schemas, row-wise + columnar codecs
  snapshot.py   Snapshot: the stored read-optimized form
  table.py      IndexedTable: segments, MVCC arena appends, compaction
  joins.py      indexed lookup and join
  planner.py    physical-operator selection (local rules L1/J1)
"""

from repro_torch.core.schema import Column, Schema
from repro_torch.core.snapshot import FlatBlock, Snapshot
from repro_torch.core.table import (IndexedTable, append, coalesce_deltas,
                                    compact, create_index)
from repro_torch.core.hashindex import HashIndex, build_index, chain_walk, probe
from repro_torch.core.hashing import StringDictionary
from repro_torch.core import joins, planner

__all__ = [
    "Schema", "Column", "IndexedTable", "Snapshot", "FlatBlock",
    "coalesce_deltas", "create_index", "append", "compact", "HashIndex",
    "StringDictionary", "build_index", "probe", "chain_walk", "joins",
    "planner",
]
