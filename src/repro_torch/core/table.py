"""IndexedTable — one partition of the Indexed DataFrame.

Paper §III-C: a partition is (1) an index pointing at the *latest* row per
key, (2) row batches holding the tabular data, (3) backward pointers
chaining equal-key rows.  Paper §III-E: appends snapshot the index so
divergent children share the parent's state and store only deltas.

A partition is an ordered tuple of **capacity-reserved arena segments**.
``create_index`` builds segment 0 over-allocated to a power-of-two
capacity class; an ``append`` that fits the reserved capacity is an
in-place ingest into the tail — hash the delta, write its bucket and chain
planes, link parent heads, bump ``fill``.  Capacity exhaustion (or a full
bucket) seals the tail and opens the next class; past a segment-count
threshold the table compacts.  ``append(..., mode="segment")`` keeps the
pre-arena path: one exactly-sized delta segment per append, parent
segments shared by reference.

Versions are values.  A non-donated arena append clones the tail's mutable
buffers before writing, so the parent and any number of divergent children
(paper Listing 2) stay independent; sealed segments are shared by
reference.  ``donate=True`` writes the parent's tail buffers in place.

Row storage is batch-granular: a segment's data is ``[num_batches,
rows_per_batch, width_words] int32`` (row layout) or per-column typed
tensors (columnar layout).

The read path (probe -> chain walk -> gather) runs over the table's stored
``Snapshot`` (core/snapshot.py).  On the card the probe and chain walk are
one launch of the hand-written lookup kernel (kernels/hash_probe.py); the
arena ingest's parent-head probe and the segment/promotion head links go
through the same kernel.  The segment-looped ``*_ref`` methods are the
reference the parity tests hold the fused path to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashindex as hix
from repro_torch.core.hashindex import EMPTY_KEY, HashIndex
from repro_torch.core.pointers import NULL_PTR, PTR_DTYPE
from repro_torch.core.schema import Schema
from repro_torch.core.snapshot import (FlatBlock, Snapshot, extend_snapshot,
                                       flat_data_from_segments, probe_view,
                                       snapshot_from_segments)
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import ops as kops

# Logical (occupied-entry) index accounting, as in the JAX package:
INDEX_ENTRY_BYTES = 12   # int64 key + int32 ptr per occupied bucket slot
ROW_PTR_BYTES = 5        # int32 prev + bool valid per live row

_DROP = hix._DROP        # row id of an invalid lane: never written


# ---------------------------------------------------------------------------
# Segment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One append unit (segment 0 = the created index)."""

    data: object          # [nb, rpb, W] int32  |  dict[name -> [nb, rpb]]
    index: HashIndex      # delta index: key -> GLOBAL row id (latest here)
    prev: torch.Tensor    # [nb*rpb] int32 — backward ptrs, GLOBAL row ids
    valid: torch.Tensor   # [nb*rpb] bool — False for padding rows
    row_base: int         # global row id of this segment's row 0
    layout: str

    @property
    def capacity(self) -> int:
        return self.prev.shape[-1]

    def _row_bytes(self) -> int:
        if self.layout == "row":
            return self.data.shape[-1] * 4
        return sum(a.element_size() for a in self.data.values())

    def data_nbytes(self, *, logical: bool = False) -> int:
        """Row-storage bytes: the reserved planes, or (``logical=True``)
        the valid rows only."""
        if logical:
            return int(self.valid.sum()) * self._row_bytes()
        if self.layout == "row":
            return self.data.numel() * 4
        return sum(a.numel() * a.element_size() for a in self.data.values())

    def index_nbytes(self, *, logical: bool = False) -> int:
        if logical:
            occupied = int((self.index.bucket_keys != EMPTY_KEY).sum())
            return (occupied * INDEX_ENTRY_BYTES
                    + int(self.valid.sum()) * ROW_PTR_BYTES)
        return self.index.nbytes + self.prev.numel() * 4 + self.valid.numel()


@dataclasses.dataclass(frozen=True)
class IndexedTable:
    """An indexed partition with MVCC versions.

    ``snapshot`` is the stored read-optimized form; ``version`` is the
    paper's MVCC version (§III-D), bumped once per append.
    """

    segments: tuple[Segment, ...]
    snapshot: Snapshot
    version: int
    schema: Schema
    rows_per_batch: int
    layout: str           # "row" | "columnar"
    slots: int

    # -- shape facts ----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.snapshot.device

    @property
    def capacity(self) -> int:
        return self.segments[-1].row_base + self.segments[-1].capacity

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def fill(self) -> torch.Tensor:
        """First unwritten global row id (0-d int32 on the device)."""
        return self.snapshot.fill

    def spare_capacity(self) -> int:
        """Reserved-but-unwritten rows left in the arena tail (reads
        ``fill`` back to the host)."""
        return self.capacity - int(self.snapshot.fill)

    def num_rows(self) -> int:
        """Valid (non-padding) rows."""
        return sum(int(s.valid.sum()) for s in self.segments)

    def data_nbytes(self, *, logical: bool = False) -> int:
        return sum(s.data_nbytes(logical=logical) for s in self.segments)

    def index_nbytes(self, *, logical: bool = False) -> int:
        """Index memory overhead — the paper's Fig-11 measurement."""
        return sum(s.index_nbytes(logical=logical) for s in self.segments)

    def _check_live(self):
        """Raise if a donated append wrote any of this version's segments
        in place: the donated parent, and every other version sharing its
        tail segment, is consumed (as a donated buffer is in JAX)."""
        if any(getattr(s, "_consumed", False) for s in self.segments):
            raise RuntimeError(
                "this table version was consumed by a donated append "
                "(append(..., donate=True) wrote a segment it holds in "
                "place); read the child that append returned")

    # -- snapshot access ------------------------------------------------------

    def with_flat_data(self) -> "IndexedTable":
        """This table with the snapshot's flat data materialized; appends
        then carry it forward."""
        if self.snapshot.data is not None:
            return self
        return dataclasses.replace(
            self, snapshot=dataclasses.replace(self.snapshot,
                                               data=self._flat_data()))

    def _flat_data(self):
        """Flat data for single-gather decode: the snapshot's copy if it
        has one, else built once and cached on this instance (outside the
        dataclass fields, so a read never changes the table)."""
        d = self.snapshot.data
        if d is not None:
            return d
        d = getattr(self, "_flatdata", None)
        if d is None:
            d = flat_data_from_segments(self.segments, self.schema,
                                        self.layout)
            object.__setattr__(self, "_flatdata", d)
        return d

    def _keys(self, keys) -> torch.Tensor:
        return on_device(keys, torch.int64, self.device)

    # -- point operations ------------------------------------------------------

    def probe_latest(self, keys) -> torch.Tensor:
        """Global row id of the *latest* row per key (NULL_PTR if absent):
        delta indexes probed newest -> oldest, first hit wins (the
        snapshot read of paper §III-E)."""
        self._check_live()
        return kops.fused_probe(self._keys(keys), self.snapshot)

    def probe_latest_ref(self, keys) -> torch.Tensor:
        """Segment-looped reference: one full probe per delta index."""
        keys = self._keys(keys)
        out = torch.full(keys.shape, NULL_PTR, dtype=PTR_DTYPE,
                         device=self.device)
        for seg in reversed(self.segments):
            hit = hix.probe(seg.index, keys)
            out = torch.where(out == NULL_PTR, hit, out)
        return out

    def gather_prev(self, rids) -> torch.Tensor:
        """prev[rid] across segments (NULL for NULL/out-of-range input)."""
        self._check_live()
        prev = self.snapshot.prev
        rids = on_device(rids, PTR_DTYPE, self.device)
        in_range = (rids >= 0) & (rids < self.snapshot.fill)
        got = prev[rids.clamp(0, prev.shape[0] - 1).long()]
        return torch.where(in_range, got, torch.full_like(got, NULL_PTR))

    def gather_prev_ref(self, rids) -> torch.Tensor:
        """Segment-looped reference: re-scans every segment per call."""
        rids = on_device(rids, PTR_DTYPE, self.device)
        out = torch.full_like(rids, NULL_PTR)
        for seg in self.segments:
            local = rids - seg.row_base
            in_seg = (local >= 0) & (local < seg.capacity)
            got = seg.prev[local.clamp(0, seg.capacity - 1).long()]
            out = torch.where(in_seg, got, out)
        return out

    def lookup(self, keys, max_matches: int):
        """[Q] keys -> ([Q, max_matches] global row ids newest-first,
        truncated flags): the paper's point lookup, probe + backward-
        pointer traversal fused into one pass over the Snapshot."""
        self._check_live()
        return kops.fused_lookup(self._keys(keys), self.snapshot,
                                 max_matches=max_matches)

    def lookup_ref(self, keys, max_matches: int):
        """Segment-looped reference lookup."""
        cur = self.probe_latest_ref(keys)
        rows = []
        for _ in range(max_matches):
            rows.append(cur)
            cur = torch.where(cur >= 0, self.gather_prev_ref(cur),
                              torch.full_like(cur, NULL_PTR))
        return torch.stack(rows, dim=1), cur >= 0

    def gather_rows(self, rids, names=None) -> dict:
        """Decode rows for global row ids (zeros where rid out of range or
        at/past ``fill``: reserved arena lanes never decode)."""
        self._check_live()
        data = self._flat_data()
        rids = on_device(rids, PTR_DTYPE, self.device)
        in_range = (rids >= 0) & (rids < self.snapshot.fill)
        safe = rids.clamp(0, self.capacity - 1).long()
        if self.layout == "row":
            # one gather per word over the flat words: ``data[safe]`` would
            # run PyTorch's row gather, one thread block per row — slow for
            # rows of a few words
            w = self.schema.width_words
            words = data.view(-1)[safe[..., None] * w
                                  + torch.arange(w, device=self.device)]
            flat = torch.where(in_range[..., None], words,
                               torch.zeros((), dtype=torch.int32,
                                           device=self.device))
            return self.schema.decode_rows(flat, names=names)
        out = {}
        for name in (names or self.schema.names):
            col = data[name]
            out[name] = torch.where(in_range, col[safe],
                                    torch.zeros((), dtype=col.dtype,
                                                device=self.device))
        return out

    def gather_rows_ref(self, rids, names=None) -> dict:
        """Segment-looped reference: one masked pass per segment."""
        rids = on_device(rids, PTR_DTYPE, self.device)
        if self.layout == "row":
            w = self.schema.width_words
            flat = torch.zeros(rids.shape + (w,), dtype=torch.int32,
                               device=self.device)
            for seg in self.segments:
                local = rids - seg.row_base
                in_seg = (local >= 0) & (local < seg.capacity)
                lc = local.clamp(0, seg.capacity - 1).long()
                got = seg.data.reshape(seg.capacity, w)[lc]
                flat = torch.where(in_seg[..., None], got, flat)
            return self.schema.decode_rows(flat, names=names)
        out = {}
        for name in (names or self.schema.names):
            col = self.schema.column(name)
            acc = torch.zeros(rids.shape, dtype=col.torch_dtype,
                              device=self.device)
            for seg in self.segments:
                local = rids - seg.row_base
                in_seg = (local >= 0) & (local < seg.capacity)
                lc = local.clamp(0, seg.capacity - 1).long()
                acc = torch.where(in_seg, seg.data[name].reshape(-1)[lc], acc)
            out[name] = acc
        return out


# ---------------------------------------------------------------------------
# Segment construction
# ---------------------------------------------------------------------------

ARENA_GROWTH = 2
DEFAULT_COMPACT_THRESHOLD = 8


def pad_to_batches(n: int, rows_per_batch: int) -> int:
    nb = max(1, -(-n // rows_per_batch))
    return nb * rows_per_batch


def capacity_class(n_rows: int, rows_per_batch: int,
                   growth: int = ARENA_GROWTH) -> int:
    """Reserved arena capacity for ``n_rows``: the smallest power-of-two
    number of row batches covering ``growth * n_rows``.  Power-of-two
    classes mean a growing table visits O(log n) distinct plane shapes,
    and ``growth`` leaves headroom so appends land in the in-place ingest
    instead of promoting immediately."""
    need = max(1, int(n_rows)) * growth
    nb = max(1, -(-need // rows_per_batch))
    return (1 << (nb - 1).bit_length()) * rows_per_batch


def prepare_cols(cols: dict, schema: Schema, rows_per_batch: int,
                 valid=None, *, min_capacity: int = 0, device):
    """Left-pack valid rows and zero-pad columns to a batch multiple (at
    least ``min_capacity`` rows), as fresh tensors on ``device``; returns
    (padded cols, valid, cap).

    Packing keeps the arena invariant — written lanes are exactly
    ``[0, valid_count)`` — and is a stable permutation, so per-key MVCC
    chain order (append order) is preserved.
    """
    n = int(len(cols[schema.columns[0].name]))
    cap = max(pad_to_batches(n, rows_per_batch),
              pad_to_batches(min_capacity, rows_per_batch)
              if min_capacity else 0)
    src = {c.name: on_device(cols[c.name], c.torch_dtype, device)
           for c in schema.columns}
    if valid is not None:
        valid = on_device(valid, torch.bool, device)
        order = torch.argsort((~valid).to(torch.int8), stable=True)
        src = {k: v[order] for k, v in src.items()}
        valid = valid[order]
    else:
        valid = torch.ones((n,), dtype=torch.bool, device=device)
    out = {}
    for c in schema.columns:
        a = torch.zeros((cap,), dtype=c.torch_dtype, device=device)
        a[:n] = src[c.name]
        out[c.name] = a
    valid_p = torch.zeros((cap,), dtype=torch.bool, device=device)
    valid_p[:n] = valid
    return out, valid_p, cap


def _masked_keys(cols: dict, valid, schema: Schema) -> torch.Tensor:
    keys = cols[schema.key].to(torch.int64)
    return torch.where(valid, keys, torch.full_like(keys, EMPTY_KEY))


def make_segment_arrays(cols: dict, valid, parent_heads, schema: Schema, *,
                        row_base: int, rows_per_batch: int, layout: str,
                        num_buckets: int, slots: int):
    """Segment constructor.

    cols         : dict of [cap]-padded typed columns
    valid        : [cap] bool
    parent_heads : [cap] int32 — parent's latest row per key (NULL if none
                   / no parent); the MVCC chain link (paper §III-E)
    Returns (Segment, overflow 0-d tensor).
    """
    cap = int(valid.shape[0])
    nb = cap // rows_per_batch
    dev = valid.device
    keys = _masked_keys(cols, valid, schema)

    if layout == "row":
        data = schema.encode_rows(cols).view(nb, rows_per_batch,
                                             schema.width_words)
    else:
        data = {c.name: cols[c.name].to(c.torch_dtype).view(
                    nb, rows_per_batch)
                for c in schema.columns}

    gids = torch.arange(cap, dtype=PTR_DTYPE, device=dev) + row_base
    bk, bp, prev_rows, prev_vals, overflow = hix._build_arrays(
        keys, gids, valid, num_buckets, slots)
    index = HashIndex(bk, bp, num_buckets, slots)

    prev = torch.full((cap,), NULL_PTR, dtype=PTR_DTYPE, device=dev)
    local = prev_rows.long() - row_base
    ok = (local >= 0) & (local < cap)
    prev[local[ok]] = prev_vals[ok]
    # chain the OLDEST row per appended key into the parent's latest row
    need_link = valid & (prev == NULL_PTR) & (parent_heads != NULL_PTR)
    prev = torch.where(need_link, parent_heads, prev)

    seg = Segment(data=data, index=index, prev=prev, valid=valid,
                  row_base=row_base, layout=layout)
    return seg, overflow


def _build_segment_retrying(cols, valid, parent_heads, schema, *, row_base,
                            rows_per_batch, layout, slots,
                            num_buckets=None, max_retries: int = 5):
    cap = int(valid.shape[0])
    nb = num_buckets or hix.suggest_num_buckets(cap, slots)
    for _ in range(max_retries):
        seg, overflow = make_segment_arrays(
            cols, valid, parent_heads, schema, row_base=row_base,
            rows_per_batch=rows_per_batch, layout=layout, num_buckets=nb,
            slots=slots)
        if int(overflow) == 0:
            return seg
        nb *= 2
    raise RuntimeError("segment index build kept overflowing")


def create_index(cols: dict, schema: Schema, *, rows_per_batch: int = 4096,
                 layout: str = "row", slots: int = hix.DEFAULT_SLOTS,
                 valid=None, reserve: int | None = None,
                 device=None) -> IndexedTable:
    """Paper Listing 1 ``createIndex``: build the index over a dataframe.

    Segment 0 is a capacity-reserved arena: its planes are over-allocated
    to the power-of-two capacity class of the input, so appends within it
    land in place.  ``reserve`` overrides the class policy: an explicit
    minimum row capacity, or ``0`` for no over-allocation.  ``device=None``
    means the CUDA card.
    """
    if layout not in ("row", "columnar"):
        raise ValueError(f"layout must be 'row' or 'columnar', got "
                         f"{layout!r}")
    dev = resolve_device(device)
    n = int(len(cols[schema.columns[0].name]))
    reserved = (capacity_class(n, rows_per_batch) if reserve is None
                else pad_to_batches(max(n, int(reserve), 1), rows_per_batch))
    cols_p, valid_p, cap = prepare_cols(cols, schema, rows_per_batch, valid,
                                        min_capacity=reserved, device=dev)
    heads = torch.full((cap,), NULL_PTR, dtype=PTR_DTYPE, device=dev)
    seg = _build_segment_retrying(cols_p, valid_p, heads, schema, row_base=0,
                                  rows_per_batch=rows_per_batch,
                                  layout=layout, slots=slots)
    snap = snapshot_from_segments((seg,), layout, schema=schema)
    return IndexedTable(segments=(seg,), snapshot=snap, version=0,
                        schema=schema, rows_per_batch=rows_per_batch,
                        layout=layout, slots=slots)


# ---------------------------------------------------------------------------
# Arena append: in-place ingest into the tail
# ---------------------------------------------------------------------------

def _delta_order(keys, valid):
    """Sort delta lanes by (key, arrival): the chain/head scaffold.

    Returns ``(order, same, is_head)`` — ``same[i]`` marks a sorted lane
    whose predecessor holds the same key (its backward pointer stays in
    the delta), ``is_head`` the newest valid lane per key (the lane that
    lands in the bucket planes).
    """
    d = keys.shape[0]
    order = hix.lexsort2(torch.arange(d, device=keys.device), keys)
    k_s, v_s = keys[order], valid[order]
    same = torch.zeros_like(v_s)
    same[1:] = (k_s[1:] == k_s[:-1]) & v_s[1:] & v_s[:-1]
    is_head = torch.ones_like(v_s)
    is_head[:-1] = k_s[1:] != k_s[:-1]
    return order, same, is_head & v_s


def _ingest_arrays(state, parent_blocks, cols_p, valid_p, *, schema, layout,
                   rb, slots):
    """Write one delta into the tail's mutable state, in place.

    state = dict(bk      [nb, slots] int64  tail bucket keys (index AND
                                            snapshot block),
                 bptr    [nb, slots] int32  tail head ptrs (index AND block),
                 sprev   [total]     int32  snapshot flat prev,
                 tprev   [cap_t] | None     tail-local prev (None when the
                                            tail is the only segment: then
                                            it IS ``sprev``),
                 tvalid  [cap_t] bool,
                 tdata   tail row storage,
                 sdata   flat data | None (None also for a single segment,
                                            whose flat data is a view of
                                            ``tdata``),
                 fill    0-d int32)
    Each buffer appears once, so each is written once.

    Returns ``(state, overflow)``.  The bucket placement is planned before
    anything is written: on a non-zero ``overflow`` (a new key found its
    bucket full) ``state`` is returned untouched and the caller promotes.
    """
    bk, bptr = state["bk"], state["bptr"]
    nb_t = bk.shape[0]
    fill_g = state["fill"]
    keys = _masked_keys(cols_p, valid_p, schema)

    order, same, is_head = _delta_order(keys, valid_p)
    k_s, v_s = keys[order], valid_p[order]
    hk = torch.where(is_head, k_s, torch.full_like(k_s, EMPTY_KEY))
    flat_slot, overflow = hix.arena_insert_plan(bk, hk, is_head)
    overflow = int(overflow)
    if overflow:
        return state, overflow

    # packed row ids: valid delta lanes land at [fill, fill + nv)
    pos = torch.cumsum(valid_p.to(torch.int64), 0) - 1
    rid_g = torch.where(valid_p, fill_g.to(torch.int64) + pos,
                        torch.full_like(pos, _DROP))
    gid_s = rid_g[order]

    # backward chains in sorted order; a key's oldest delta row links to
    # the parent's head, found by probing the PRE-write state (newest ->
    # oldest across every segment) — on the card, the lookup kernel
    pred = torch.full_like(gid_s, NULL_PTR)
    pred[1:] = gid_s[:-1]
    view = probe_view(tuple(parent_blocks) + (FlatBlock(bk, bptr, nb_t),),
                      state["sprev"], fill_g, layout=layout)
    parent_head = kops.fused_probe(k_s, view).to(torch.int64)
    prev_vals = torch.where(same, pred, parent_head).to(PTR_DTYPE)

    g = gid_s[v_s]
    state["sprev"][g] = prev_vals[v_s]
    if state["tprev"] is not None:
        state["tprev"][g - rb] = prev_vals[v_s]

    # row data, in delta order
    rid_l = rid_g[valid_p] - rb
    state["tvalid"][rid_l] = True
    if layout == "row":
        w = schema.width_words
        words = schema.encode_rows(cols_p)[valid_p]
        state["tdata"].view(-1, w)[rid_l] = words
        if state["sdata"] is not None:
            state["sdata"][rid_l + rb] = words
    else:
        for c in schema.columns:
            vals = cols_p[c.name][valid_p]
            state["tdata"][c.name].view(-1)[rid_l] = vals
            if state["sdata"] is not None:
                state["sdata"][c.name][rid_l + rb] = vals

    # bucket/head insert on the tail planes (index + snapshot block)
    ok = flat_slot < nb_t * slots
    bk.view(-1)[flat_slot[ok]] = hk[ok]
    bptr.view(-1)[flat_slot[ok]] = gid_s[ok].to(PTR_DTYPE)

    state["fill"] = fill_g + valid_p.sum().to(torch.int32)
    return state, 0


def _clone(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v.clone() for k, v in x.items()}
    return x.clone()


def _dedup_state(table: IndexedTable, *, clone: bool) -> dict:
    """The tail's mutable buffers, each exactly once; copies of them when
    ``clone`` (a non-donated append must leave its parent untouched)."""
    tail = table.segments[-1]
    snap = table.snapshot
    single = len(table.segments) == 1
    state = dict(bk=tail.index.bucket_keys,
                 bptr=tail.index.bucket_ptrs,
                 sprev=snap.prev,
                 tprev=None if single else tail.prev,
                 tvalid=tail.valid,
                 tdata=tail.data,
                 sdata=None if single else snap.data,
                 fill=snap.fill)
    if clone:
        state = {k: (v if k == "fill" else _clone(v))
                 for k, v in state.items()}
    return state


def _reassemble(table: IndexedTable, out: dict) -> IndexedTable:
    """The child table from an ingest's output state: the tail index and
    snapshot block share ONE pair of planes, and a single-segment tail
    shares its prev (and its flat data, as a view) with the snapshot."""
    tail = table.segments[-1]
    snap = table.snapshot
    sch = table.schema
    single = len(table.segments) == 1
    nb_t = tail.index.num_buckets
    tail_new = dataclasses.replace(
        tail, data=out["tdata"], valid=out["tvalid"],
        prev=out["sprev"] if single else out["tprev"],
        index=HashIndex(out["bk"], out["bptr"], nb_t, tail.index.slots))
    if snap.data is None:
        sdata = None
    elif single:
        sdata = flat_data_from_segments((tail_new,), sch, table.layout)
    else:
        sdata = out["sdata"]
    blk_new = FlatBlock(keys=out["bk"], ptrs=out["bptr"], num_buckets=nb_t)
    snap_new = Snapshot(blocks=snap.blocks[:-1] + (blk_new,),
                        prev=out["sprev"], data=sdata, fill=out["fill"],
                        layout=snap.layout)
    return dataclasses.replace(table, segments=table.segments[:-1]
                               + (tail_new,), snapshot=snap_new,
                               version=table.version + 1)


def _append_promote(table: IndexedTable, cols_p: dict, valid_p, nv: int
                    ) -> IndexedTable:
    """Capacity exhaustion (or bucket overflow): seal the tail and open a
    fresh arena segment at the next capacity class — at least double the
    sealed tail, and large enough for the delta's own class."""
    rpb = table.rows_per_batch
    tail_cap = table.segments[-1].capacity
    # prepare_cols left-packed the valid rows, so a sparse delta is
    # trimmed to its valid-row class before padding
    keep = pad_to_batches(max(nv, 1), rpb)
    if keep < valid_p.shape[0]:
        cols_p = {k: v[:keep] for k, v in cols_p.items()}
        valid_p = valid_p[:keep]
    new_cap = max(2 * tail_cap, capacity_class(max(nv, 1), rpb),
                  valid_p.shape[0])
    n = valid_p.shape[0]
    cols_r = {}
    for k, v in cols_p.items():
        a = torch.zeros((new_cap,), dtype=v.dtype, device=v.device)
        a[:n] = v
        cols_r[k] = a
    valid_r = torch.zeros((new_cap,), dtype=torch.bool,
                          device=valid_p.device)
    valid_r[:n] = valid_p
    heads = table.probe_latest(_masked_keys(cols_r, valid_r, table.schema))
    seg = _build_segment_retrying(cols_r, valid_r, heads, table.schema,
                                  row_base=table.capacity,
                                  rows_per_batch=rpb, layout=table.layout,
                                  slots=table.slots)
    snap = extend_snapshot(table.snapshot, seg, schema=table.schema)
    return dataclasses.replace(table, segments=table.segments + (seg,),
                               snapshot=snap, version=table.version + 1)


def append(table: IndexedTable, cols: dict, valid=None, *,
           mode: str = "arena", donate: bool = False,
           compact_threshold: int | None = None) -> IndexedTable:
    """Paper Listing 1 ``appendRows``: append -> a new version.

    ``mode="arena"`` (default): within the tail's reserved capacity the
    delta lands by the in-place ingest.  On capacity exhaustion (or bucket
    overflow) the tail is sealed and a next-class arena opens; when the
    segment count then exceeds ``compact_threshold`` (default
    ``DEFAULT_COMPACT_THRESHOLD``) the table is compacted.

    ``donate=False`` clones the tail's mutable buffers and writes the
    clones: the parent stays readable and unchanged, so divergent appends
    on one parent (paper Listing 2) are independent.  ``donate=True`` is a
    true in-place write into the parent's tail buffers, with no copy: the
    parent is consumed (reading it raises), and so is every other version
    that holds its tail segment (children made from it by
    ``mode="segment"`` or by promotion), as every holder of a donated
    buffer is in JAX.

    ``mode="segment"`` is the pre-arena path — one exactly-sized delta
    segment per append, parent buffers shared by reference.
    """
    table._check_live()
    if mode not in ("arena", "segment"):
        raise ValueError(f"append mode must be 'arena' or 'segment', "
                         f"got {mode!r}")
    cols_p, valid_p, _ = prepare_cols(cols, table.schema,
                                      table.rows_per_batch, valid,
                                      device=table.device)
    if mode == "segment":
        heads = table.probe_latest(_masked_keys(cols_p, valid_p,
                                                table.schema))
        seg = _build_segment_retrying(cols_p, valid_p, heads, table.schema,
                                      row_base=table.capacity,
                                      rows_per_batch=table.rows_per_batch,
                                      layout=table.layout,
                                      slots=table.slots)
        snap = extend_snapshot(table.snapshot, seg, schema=table.schema)
        child = dataclasses.replace(table,
                                    segments=table.segments + (seg,),
                                    snapshot=snap,
                                    version=table.version + 1)
        if compact_threshold is not None \
                and child.num_segments > compact_threshold:
            child = compact(child, _bump_version=False)
        return child

    nv = int(valid_p.sum())
    if nv <= table.spare_capacity():
        out, overflow = _ingest_arrays(
            _dedup_state(table, clone=not donate),
            table.snapshot.blocks[:-1], cols_p, valid_p,
            schema=table.schema, layout=table.layout,
            rb=table.segments[-1].row_base, slots=table.slots)
        if overflow == 0:
            child = _reassemble(table, out)
            if donate:
                object.__setattr__(table.segments[-1], "_consumed", True)
            return child
    child = _append_promote(table, cols_p, valid_p, nv)
    threshold = (DEFAULT_COMPACT_THRESHOLD if compact_threshold is None
                 else compact_threshold)
    if child.num_segments > threshold:
        child = compact(child, _bump_version=False)
    return child


def _cat(parts):
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(parts)
    return np.concatenate([np.asarray(p) for p in parts])


def coalesce_deltas(deltas, schema: Schema, valids=None):
    """Concatenate N append deltas into ONE delta.

    Delta ``i``'s rows precede delta ``i+1``'s, and the arena ingest sorts
    on (key, arrival lane), so landing the coalesced delta through one
    ``append`` yields per-key MVCC chains bit-identical to N sequential
    appends, paying the per-append host round trips once.  The coalesced
    append bumps the version once.

    Returns ``(cols, valid)`` — ``valid`` is None when ``valids`` is None
    (every row valid), else the concatenation with per-delta ``None``
    meaning all-valid.  Host arrays concatenate with numpy, tensors with
    torch on their device.
    """
    deltas = list(deltas)
    if not deltas:
        raise ValueError("coalesce_deltas needs at least one delta")
    cols = {c.name: _cat([d[c.name] for d in deltas])
            for c in schema.columns}
    if valids is None:
        return cols, None
    valids = list(valids)
    if len(valids) != len(deltas):
        raise ValueError(f"{len(valids)} validity masks for "
                         f"{len(deltas)} deltas")
    valid = np.concatenate([
        np.ones(len(d[schema.key]), bool) if v is None
        else np.asarray(v, bool)
        for d, v in zip(deltas, valids)])
    return cols, valid


def compact(table: IndexedTable, *, reserve: int | None = None,
            _bump_version: bool = True) -> IndexedTable:
    """Merge all segments into one fresh arena (bounds probe fan-out after
    promotions).  The result is reserved at the capacity class of the live
    row count, so later appends re-enter the in-place path."""
    table._check_live()
    if table.num_segments == 1 and reserve is None:
        return table
    valid_all = torch.cat([s.valid for s in table.segments])
    bases = torch.cat([torch.arange(s.capacity, device=table.device)
                       + s.row_base for s in table.segments])
    cols = table.gather_rows(bases[valid_all].to(PTR_DTYPE))
    fresh = create_index(cols, table.schema,
                         rows_per_batch=table.rows_per_batch,
                         layout=table.layout, slots=table.slots,
                         reserve=reserve, device=table.device)
    version = table.version + 1 if _bump_version else table.version
    return dataclasses.replace(fresh, version=version)
