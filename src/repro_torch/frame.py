"""IndexedFrame — the paper's Indexed DataFrame facade, local backend.

The paper's public object (Listing 1) is a single *Indexed DataFrame*
with ``createIndex / getRows / appendRows / join``.  This port of the JAX
package's facade (repro/frame.py) carries the single-partition path:

* ``IndexedFrame.from_columns(cols, schema)`` builds a local
  ``IndexedTable`` on ``device`` (``None`` means the CUDA card);
* ``.lookup`` / ``.join`` go through the planner's physical-operator
  selection (rules L1 / J1), and ``.plan_lookup(...).explain()`` names the
  rule that fired;
* ``.append`` is the MVCC write path (the parent stays queryable unless
  ``donate=True``); a *list* of deltas is coalesced into ONE ingest
  (``core.table.coalesce_deltas``);
* ``.compact`` merges segments.

Methods of the JAX facade that belong to parts not yet ported raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core import joins
from repro_torch.core import planner as planner_mod
from repro_torch.core import table as table_mod
from repro_torch.core.schema import Schema

_LOOKUP_OPS = ("auto", "local", "bcast", "routed", "hybrid")
_JOIN_OPS = ("auto", "local", "bcast", "shuffle", "hybrid")


def _hash_string_cols(cols: dict, schema: Schema,
                      dictionary: "hashing.StringDictionary | None" = None
                      ) -> dict:
    """String-valued columns -> int64 FNV-1a keys, vectorized on the host
    (``hashing.hash_strings_host``, or the optional ``StringDictionary``
    cache).  Tensors and numeric columns pass through untouched."""
    encode = (hashing.hash_strings_host if dictionary is None
              else dictionary.encode)
    out, changed = dict(cols), False
    for name, v in cols.items():
        if isinstance(v, torch.Tensor):
            continue
        a = np.asarray(v)
        if a.dtype.kind in "US" or (a.dtype.kind == "O" and a.size
                                    and isinstance(a.reshape(-1)[0], str)):
            out[name] = encode(a)
            changed = True
    return out if changed else cols


def _not_ported(name: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"IndexedFrame.{name} is not ported yet: ROADMAP.md item {item}")
    method.__name__ = name
    method.__doc__ = f"Not ported yet (ROADMAP.md item {item})."
    return method


@dataclasses.dataclass(frozen=True)
class IndexedFrame:
    """The paper's Indexed DataFrame over one local partition.

    ``data`` is the wrapped ``core.table.IndexedTable``.
    """

    data: Any

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_columns(cls, cols: dict, schema: Schema, *, num_shards: int = 1,
                     rt=None, rows_per_batch: int = 4096, layout: str = "row",
                     slots: int | None = None, valid=None,
                     reserve: int | None = None,
                     track_hot: int | None = None, hot_mode: str = "topk",
                     partition_by=None,
                     dictionary: "hashing.StringDictionary | None" = None,
                     device=None) -> "IndexedFrame":
        """Paper Listing 1 ``createIndex``: build the index over a keyed
        columnar dict on ``device`` (``None`` means the CUDA card; there
        is no silent move to the CPU).  String-valued columns are hashed
        to int64 keys; ``dictionary`` caches the vocabulary across
        batches.  ``num_shards``/``rt``, ``track_hot``/``hot_mode`` and
        ``partition_by`` take only their defaults until the distributed
        layer (A12), the hot-key tracker (A7) and partitions (A9) are
        ported."""
        for name, item, given in [
                ("num_shards", "A12", num_shards != 1),
                ("rt", "A12", rt is not None),
                ("track_hot", "A7", track_hot is not None),
                ("hot_mode", "A7", hot_mode != "topk"),
                ("partition_by", "A9", partition_by is not None)]:
            if given:
                raise NotImplementedError(
                    f"from_columns({name}=...) is not ported yet: "
                    f"ROADMAP.md item {item}")
        cols = _hash_string_cols(cols, schema, dictionary)
        kw = {} if slots is None else {"slots": slots}
        t = table_mod.create_index(
            cols, schema, rows_per_batch=rows_per_batch, layout=layout,
            valid=valid, reserve=reserve, device=device, **kw)
        return cls(data=t)

    # -- shape facts / passthroughs -------------------------------------------

    is_distributed = False
    is_partitioned = False
    num_shards = 1
    num_partitions = 1
    partition_ids = ()

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def schema(self) -> Schema:
        return self.data.schema

    @property
    def version(self) -> int:
        return self.data.version

    def num_rows(self) -> int:
        return self.data.num_rows()

    def index_nbytes(self, **kw) -> int:
        return self.data.index_nbytes(**kw)

    def data_nbytes(self, **kw) -> int:
        return self.data.data_nbytes(**kw)

    @staticmethod
    def _planner(planner: planner_mod.Planner | None) -> planner_mod.Planner:
        return planner_mod.Planner() if planner is None else planner

    # -- reads: planner-routed physical operators -----------------------------

    def _forced_plan(self, op: str, ops: tuple, local_kind: str
                     ) -> planner_mod.Physical:
        """A Physical node for an explicitly forced flavor; every flavor
        but the local one needs shards."""
        if op not in ops:
            raise ValueError(f"op must be one of {ops}, got {op!r}")
        if op != "local":
            raise ValueError(
                f"op={op!r} needs a distributed frame; this frame has "
                f"{self.num_shards} shard(s)")
        return planner_mod.Physical(local_kind, f"forced: op={op!r}",
                                    self.data)

    @staticmethod
    def _annotate(phys: planner_mod.Physical) -> planner_mod.Physical:
        """The uniform reason suffix of every planned read.  This port has
        no append ring yet (ROADMAP.md item A8), so no rows are pending."""
        return dataclasses.replace(
            phys, reason=phys.reason + "; pending_ring_rows=0")

    def plan_lookup(self, keys, *, max_matches: int = 64, op: str = "auto",
                    planner: planner_mod.Planner | None = None
                    ) -> planner_mod.Physical:
        """The physical operator ``lookup`` would run for this query batch
        — ``.explain()`` on the result names the rule."""
        if op == "auto":
            phys = self._planner(planner).physical_lookup(
                self.data, int(len(keys)), keys=keys)
        else:
            phys = self._forced_plan(op, _LOOKUP_OPS, "IndexedLookup")
        return self._annotate(phys)

    def lookup(self, keys, *, max_matches: int = 64, names=None,
               op: str = "auto",
               planner: planner_mod.Planner | None = None):
        """Paper Listing 1 ``getRows``: rows for each key, newest-first.

        Returns ``(cols [Q, max_matches], valid [Q, max_matches])``.
        """
        joins.check_max_matches(max_matches)
        keys = joins.as_int64_keys(keys, self.device)
        # one local operator: planning only validates a forced ``op``
        self.plan_lookup(keys, max_matches=max_matches, op=op,
                         planner=planner)
        return joins.indexed_lookup(self.data, keys,
                                    max_matches=max_matches, names=names)

    def plan_join(self, probe_cols: dict, on: str, *, max_matches: int = 64,
                  op: str = "auto",
                  planner: planner_mod.Planner | None = None
                  ) -> planner_mod.Physical:
        """The physical operator ``join`` would run for this probe side."""
        if op == "auto":
            phys = self._planner(planner).physical_join(
                self.data, int(len(probe_cols[on])), keys=probe_cols[on])
        else:
            phys = self._forced_plan(op, _JOIN_OPS, "IndexedJoin")
        return self._annotate(phys)

    def join(self, probe_cols: dict, on: str, *, max_matches: int = 64,
             names=None, op: str = "auto",
             planner: planner_mod.Planner | None = None):
        """Equi-join with this frame as the build side.

        Returns ``(build_cols [Q, M], probe_cols broadcast [Q, M],
        valid [Q, M])``.
        """
        joins.check_max_matches(max_matches)
        keys = joins.as_int64_keys(probe_cols[on], self.device)
        # one local operator: planning only validates a forced ``op``
        self.plan_join(probe_cols, on, max_matches=max_matches, op=op,
                       planner=planner)
        return joins.indexed_join(self.data, {**probe_cols, on: keys}, on,
                                  max_matches=max_matches, names=names)

    # -- writes: MVCC appends, compaction -------------------------------------

    def append(self, cols, valid=None, *, donate: bool = False,
               mode: str = "arena", queued: bool = False,
               compact_threshold: int | None = None,
               dictionary: "hashing.StringDictionary | None" = None
               ) -> "IndexedFrame":
        """Paper Listing 1 ``appendRows``: append -> a new frame; the
        parent stays queryable (divergent MVCC children, Listing 2) unless
        ``donate=True`` writes its buffers in place.

        ``cols`` may be a list/tuple of deltas: they are coalesced
        (``core.table.coalesce_deltas``) and land through ONE ingest with
        one version bump.  ``valid`` is then a matching list of masks (or
        None).
        """
        if queued:
            raise NotImplementedError(
                "append(queued=True) needs the append ring: ROADMAP.md "
                "item A8")
        if isinstance(cols, (list, tuple)):
            cols, valid = table_mod.coalesce_deltas(
                [_hash_string_cols(d, self.schema, dictionary)
                 for d in cols],
                self.schema, valid)
        else:
            cols = _hash_string_cols(cols, self.schema, dictionary)
        new = table_mod.append(self.data, cols, valid, mode=mode,
                               donate=donate,
                               compact_threshold=compact_threshold)
        return dataclasses.replace(self, data=new)

    def compact(self, *, reserve: int | None = None) -> "IndexedFrame":
        """Merge all segments into one fresh arena — lookups bit-identical
        before and after."""
        return dataclasses.replace(
            self, data=table_mod.compact(self.data, reserve=reserve))

    # -- not ported yet ---------------------------------------------------------

    pending_deltas = property(_not_ported("pending_deltas", "A8"))
    pending_rows = property(_not_ported("pending_rows", "A8"))
    with_queue = _not_ported("with_queue", "A8")
    enqueue = _not_ported("enqueue", "A8")
    flush = _not_ported("flush", "A8")
    with_hot_tracker = _not_ported("with_hot_tracker", "A7")
    drop_partition = _not_ported("drop_partition", "A9")
    retain = _not_ported("retain", "A9")
    per_partition_bytes = _not_ported("per_partition_bytes", "A9")
    serve = _not_ported("serve", "A11")
    with_replica = _not_ported("with_replica", "A12")
    refresh_replica = _not_ported("refresh_replica", "A12")
    supervised = _not_ported("supervised", "A12")
    reshard = _not_ported("reshard", "A12")
    relation = _not_ported("relation", "A6")
    filter = _not_ported("filter", "A6")
    select = _not_ported("select", "A6")
    agg = _not_ported("agg", "A6")
    save = _not_ported("save", "A6")
    load = classmethod(_not_ported("load", "A6"))
