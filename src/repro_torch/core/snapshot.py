"""Snapshot — the read-optimized stored form of an IndexedTable.

The paper's core claim (Fig 1, §III-C) is that the index is built once and
probed many times, so the probe must not scale with the number of MVCC
append segments.  The fused probe -> chain walk -> gather therefore runs
over a flat multi-segment view:

* per-segment ``FlatBlock``s — each segment's bucket planes at the
  segment's own bucket count (ragged: bucket ids are computed modulo each
  segment's ``num_buckets``, nothing is padded);
* ``prev [capacity] int32`` — the segments' backward-pointer arrays in
  global row order, so a chain walk is one gather per hop;
* ``data`` — optional contiguous row storage for single-gather decode
  (``None`` until a version asks for it);
* ``fill`` — a 0-d int32 tensor on the table's device: the first unwritten
  global row id.  Every emitted row id is masked by it, so the reserved
  but unwritten lanes of an arena tail never answer a read.  The lookup
  kernel reads it from device memory, so a read needs no host sync.

**Key planes.**  The JAX package keeps each block's keys twice: the
index's int64 ``bucket_keys`` and split (hi, lo) int32 planes, because the
TPU has no 64-bit vector lanes.  A CUDA thread compares int64 natively, so
here a block holds the segment's own ``bucket_keys`` and ``bucket_ptrs``
tensors *by reference*: one copy of each plane, shared between the index
and the snapshot, and written once by an arena append.

Blocks are shared by reference across versions: ``extend_snapshot`` adds
one block for the delta and never rebuilds a parent block, so divergent
children (paper Listing 2) need no copy of their parent's planes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FlatBlock:
    """One segment's probe-side planes (the segment index's own tensors)."""

    keys: torch.Tensor    # [nb, slots] int64 — bucket keys (EMPTY = min)
    ptrs: torch.Tensor    # [nb, slots] int32 — head ptrs (GLOBAL row ids)
    num_buckets: int


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Flat multi-segment view of one table version.

    ``kernel_desc`` caches the lookup kernel's device descriptor of the
    blocks (kernels/hash_probe.py); it is built on the first kernel launch
    against this version and is not carried to other versions.
    """

    blocks: tuple[FlatBlock, ...]
    prev: torch.Tensor              # [capacity] int32, global row order
    data: object                    # None | [cap, W] int32 | dict[name->[cap]]
    fill: torch.Tensor              # 0-d int32 — first unwritten row id
    layout: str
    kernel_desc: object = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)

    @property
    def bucket_counts(self) -> tuple[int, ...]:
        return tuple(b.num_buckets for b in self.blocks)

    @property
    def capacity(self) -> int:
        return self.prev.shape[-1]

    @property
    def num_segments(self) -> int:
        return len(self.blocks)

    @property
    def device(self) -> torch.device:
        return self.prev.device


def probe_view(blocks, prev, fill, *, layout) -> Snapshot:
    """A probe-side-only Snapshot over explicit planes (``data=None``).

    The arena ingest probes the pre-write table state through it for the
    parent head links.  The fill mask is the contract: a row id at or past
    ``fill`` never decodes.
    """
    return Snapshot(blocks=tuple(blocks), prev=prev, data=None, fill=fill,
                    layout=layout)


def block_from_segment(seg) -> FlatBlock:
    """A segment's probe-side block: its index planes, by reference."""
    return FlatBlock(keys=seg.index.bucket_keys, ptrs=seg.index.bucket_ptrs,
                     num_buckets=seg.index.num_buckets)


def flat_data_from_segments(segments, schema, layout):
    """Contiguous data for single-gather row decode.  A single segment's
    data is returned as a view; several segments are concatenated."""
    if layout == "row":
        w = schema.width_words
        if len(segments) == 1:
            return segments[0].data.view(segments[0].capacity, w)
        return torch.cat([s.data.view(s.capacity, w) for s in segments])
    if len(segments) == 1:
        return {c.name: segments[0].data[c.name].view(-1)
                for c in schema.columns}
    return {c.name: torch.cat([s.data[c.name].view(-1) for s in segments])
            for c in schema.columns}


def fill_after(seg) -> torch.Tensor:
    """First unwritten row id given a tail segment: one past its last
    valid lane (its ``row_base`` when the segment holds no valid row)."""
    v = seg.valid
    cap = v.shape[-1]
    last = cap - torch.flip(v, (0,)).to(torch.int8).argmax()
    last = torch.where(v.any(), last, torch.zeros_like(last))
    return (last + seg.row_base).to(torch.int32)


def snapshot_from_segments(segments, layout, *, schema=None,
                           with_data: bool = False) -> Snapshot:
    """Build a Snapshot from scratch (create_index / compact path).  A
    single segment's ``prev`` is shared with the snapshot, not copied."""
    blocks = tuple(block_from_segment(s) for s in segments)
    prev = (segments[0].prev if len(segments) == 1
            else torch.cat([s.prev for s in segments]))
    data = (flat_data_from_segments(segments, schema, layout)
            if with_data else None)
    return Snapshot(blocks=blocks, prev=prev, data=data,
                    fill=fill_after(segments[-1]), layout=layout)


def extend_snapshot(snap: Snapshot, seg, *, schema) -> Snapshot:
    """Parent snapshot + one delta segment -> child snapshot.

    One block for the delta plus one ``prev`` concat; parent blocks are
    reused by reference.  Flat data is extended only when the parent had
    materialized it.
    """
    block = block_from_segment(seg)
    prev = torch.cat([snap.prev, seg.prev])
    if snap.data is None:
        data = None
    elif snap.layout == "row":
        data = torch.cat([snap.data,
                          seg.data.view(seg.capacity, schema.width_words)])
    else:
        data = {c.name: torch.cat([snap.data[c.name],
                                   seg.data[c.name].view(-1)])
                for c in schema.columns}
    return Snapshot(blocks=snap.blocks + (block,), prev=prev, data=data,
                    fill=fill_after(seg), layout=snap.layout)


def strip_data(snap: Snapshot) -> Snapshot:
    """Probe-side-only view of a snapshot."""
    if snap.data is None:
        return snap
    return dataclasses.replace(snap, data=None)
