"""Dense bucketized hash index — the replacement for the paper's cTrie.

The cTrie (§III-C) maps ``key -> pointer to the latest row holding that
key``; rows sharing a key are chained through backward pointers.  The
index keeps that contract in two dense planes:

* ``bucket_keys : [num_buckets, slots] int64``  (EMPTY = int64 min)
* ``bucket_ptrs : [num_buckets, slots] int32``  (flat row id, NULL = -1)

A probe is one gather of a ``[Q, slots]`` tile and a compare.  Inserts are
bulk: hash -> sort -> segment rank -> one scatter.  If a bulk build
overflows a bucket, the build reports ``overflow`` and the host wrapper
retries with twice the buckets, so probes are exact for every inserted key.

Every scatter here writes only the lanes that are in range: a torch index
out of range raises on the CPU and fires a device assert on CUDA, where the
JAX package's ``mode="drop"`` silently skipped them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hashing
from repro_torch.core.pointers import NULL_PTR, PTR_DTYPE

EMPTY_KEY = -(1 << 63)
DEFAULT_SLOTS = 8
_DROP = 2**31 - 1          # row id of an invalid lane: never a scatter target


@dataclasses.dataclass(frozen=True)
class HashIndex:
    """Dense hash index over one table segment."""

    bucket_keys: torch.Tensor  # [num_buckets, slots] int64
    bucket_ptrs: torch.Tensor  # [num_buckets, slots] int32 (flat row ids)
    num_buckets: int
    slots: int

    @property
    def nbytes(self) -> int:
        return self.bucket_keys.numel() * 8 + self.bucket_ptrs.numel() * 4


# ---------------------------------------------------------------------------
# Bulk build
# ---------------------------------------------------------------------------

def lexsort2(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))``: order by ``primary``, ties by
    ``secondary`` — two stable sorts, secondary first."""
    o1 = torch.argsort(secondary, stable=True)
    o2 = torch.argsort(primary[o1], stable=True)
    return o1[o2]


def _segment_rank(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal ``sorted_ids``."""
    n = sorted_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    start = torch.where(is_start, idx, torch.full_like(idx, -1))
    if n:
        start = torch.cummax(start, dim=0).values
    return (idx - start).to(torch.int32)


def _shifted(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` moved one lane right, ``fill`` in lane 0."""
    out = torch.empty_like(x)
    if x.shape[0]:
        out[0] = fill
        out[1:] = x[:-1]
    return out


def _build_arrays(keys, row_ids, valid, num_buckets: int, slots: int):
    """One build pass.  Returns ``(bucket_keys, bucket_ptrs, prev_rows,
    prev_vals, overflow)``.

    ``prev_rows``/``prev_vals`` are the backward-pointer scatter pairs; the
    caller applies them to its own row space.  Invalid lanes carry row id
    int32 max, so any caller-side offset still lands out of range.
    ``overflow`` is a 0-d tensor (no host sync here).
    """
    dev = keys.device
    keys = torch.where(valid, keys, torch.full_like(keys, EMPTY_KEY))

    # backward pointers: sort by (key, row id)
    order = lexsort2(row_ids, keys)
    k_s, r_s, v_s = keys[order], row_ids[order], valid[order]
    same_as_prev = torch.zeros_like(v_s)
    same_as_prev[1:] = (k_s[1:] == k_s[:-1]) & v_s[1:] & v_s[:-1]
    r_s = r_s.to(PTR_DTYPE)
    null = torch.full_like(r_s, NULL_PTR)
    prev_vals = torch.where(same_as_prev, _shifted(r_s, NULL_PTR), null)
    prev_rows = torch.where(v_s, r_s, torch.full_like(r_s, _DROP))

    # head per key: last element of each equal-key run
    is_head = torch.ones_like(v_s)
    is_head[:-1] = k_s[1:] != k_s[:-1]
    is_head &= v_s

    # bucket placement: heads sorted by bucket, non-heads to the end
    bucket = hashing.bucket_hash(k_s, num_buckets)
    b_or_inf = torch.where(is_head, bucket,
                           torch.full_like(bucket, num_buckets))
    order2 = torch.argsort(b_or_inf, stable=True)
    b2, k2, r2, head2 = (b_or_inf[order2], k_s[order2], r_s[order2],
                         is_head[order2])
    rank = _segment_rank(b2)
    overflow = ((rank >= slots) & head2).sum()
    ok = head2 & (rank < slots)
    flat = b2.to(torch.int64)[ok] * slots + rank[ok]

    bucket_keys = torch.full((num_buckets * slots,), EMPTY_KEY,
                             dtype=torch.int64, device=dev)
    bucket_ptrs = torch.full((num_buckets * slots,), NULL_PTR,
                             dtype=PTR_DTYPE, device=dev)
    bucket_keys[flat] = k2[ok]
    bucket_ptrs[flat] = r2[ok]
    return (bucket_keys.view(num_buckets, slots),
            bucket_ptrs.view(num_buckets, slots),
            prev_rows, prev_vals, overflow)


def arena_insert_plan(bucket_keys, head_keys, is_head):
    """Slot placement for inserting per-key head pointers into a live
    bucket table (the arena append path).

    Builds and arena inserts keep each bucket's occupied slots packed
    left, so a head whose key already sits in the table reuses its slot
    and a new key takes ``occupancy + rank``, ``rank`` ordering the batch's
    new keys within their bucket.  Returns ``(flat_slot [d] int64,
    overflow 0-d)``; ``flat_slot`` indexes the flattened ``[nb * slots]``
    planes and is ``nb * slots`` (out of range: not written) for non-head
    lanes and overflowing inserts.
    """
    nb, slots = bucket_keys.shape
    b = hashing.bucket_hash(head_keys, nb).to(torch.int64)
    row_keys = bucket_keys[b]                               # [d, slots]
    match = ((row_keys == head_keys[:, None]) & is_head[:, None]
             & (head_keys != EMPTY_KEY)[:, None])
    exists = match.any(dim=1)
    slot_exist = match.to(torch.int8).argmax(dim=1)
    # occupancy of each touched bucket, from the rows already gathered:
    # O(delta), where a count over the whole table would be O(table)
    occ = (row_keys != EMPTY_KEY).sum(dim=1)
    new_head = is_head & ~exists
    b_or_inf = torch.where(new_head, b, torch.full_like(b, nb))
    order = torch.argsort(b_or_inf, stable=True)
    rank = torch.empty_like(b)
    rank[order] = _segment_rank(b_or_inf[order]).to(torch.int64)
    slot_new = occ + rank
    overflow = (new_head & (slot_new >= slots)).sum()
    slot = torch.where(exists, slot_exist, slot_new)
    ok = is_head & (slot < slots)
    flat = torch.where(ok, b * slots + slot, torch.full_like(b, nb * slots))
    return flat, overflow


def suggest_num_buckets(n_keys: int, slots: int = DEFAULT_SLOTS,
                        load: float = 0.25) -> int:
    """Power-of-two bucket count targeting ``load`` mean occupancy/slot."""
    want = max(16, int(n_keys / max(1, slots * load)))
    return 1 << (want - 1).bit_length()


def build_index(keys, row_ids, *, valid=None, num_buckets: int | None = None,
                slots: int = DEFAULT_SLOTS, max_retries: int = 4):
    """Host-coordinated build with overflow-doubling retry.

    Returns ``(HashIndex, prev_rows, prev_vals)``.  ``keys`` and
    ``row_ids`` are tensors on the device the index should live on.
    """
    keys = keys.to(torch.int64)
    row_ids = row_ids.to(PTR_DTYPE)
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    nb = num_buckets or suggest_num_buckets(int(keys.shape[0]), slots)
    for _ in range(max_retries):
        bk, bp, prev_rows, prev_vals, overflow = _build_arrays(
            keys, row_ids, valid, nb, slots)
        if int(overflow) == 0:
            return HashIndex(bk, bp, nb, slots), prev_rows, prev_vals
        nb *= 2
    raise RuntimeError(
        f"hash index build overflowed after {max_retries} doublings "
        f"(final num_buckets={nb}); pathological key distribution?")


# ---------------------------------------------------------------------------
# Probe and chain walk (single index; the fused multi-segment path is
# kernels/ops.fused_lookup)
# ---------------------------------------------------------------------------

def probe(index: HashIndex, query_keys: torch.Tensor) -> torch.Tensor:
    """Latest row id per query key (NULL_PTR where absent).  [Q] int32."""
    q = query_keys.to(torch.int64)
    b = hashing.bucket_hash(q, index.num_buckets).to(torch.int64)
    keys_b = index.bucket_keys[b]                       # [Q, S] gather
    ptrs_b = index.bucket_ptrs[b]
    hit = (keys_b == q[:, None]) & (q[:, None] != EMPTY_KEY)
    slot = hit.to(torch.int8).argmax(dim=1)
    ptr = torch.gather(ptrs_b, 1, slot[:, None])[:, 0]
    return torch.where(hit.any(dim=1), ptr, torch.full_like(ptr, NULL_PTR))


def chain_walk(prev: torch.Tensor, head_ptrs: torch.Tensor,
               max_matches: int):
    """Follow backward pointers: [Q] head ptrs -> ([Q, max_matches] row
    ids newest-first NULL-padded, truncated [Q] bool)."""
    cap = prev.shape[0]
    cur = head_ptrs.to(PTR_DTYPE)
    null = torch.full_like(cur, NULL_PTR)
    rows = []
    for _ in range(max_matches):
        rows.append(cur)
        got = prev[cur.clamp(0, cap - 1).to(torch.int64)]
        cur = torch.where(cur >= 0, got, null)
    if not rows:
        return cur.new_empty((cur.shape[0], 0)), cur >= 0
    return torch.stack(rows, dim=1), cur >= 0


def match_counts(prev, head_ptrs, max_matches: int):
    rows, _ = chain_walk(prev, head_ptrs, max_matches)
    return (rows >= 0).sum(dim=1)
