"""Plain PyTorch versions of the port's kernels.

Each function is the semantic contract of its kernel: the CPU path runs
it, and the card's kernel is held bit-identical to it on the same inputs
(chip_smoke.py).  Inputs are what the kernel takes: int64 query keys and a
``core.snapshot.Snapshot``; bucket ids are computed here, as the kernel
computes them itself.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.pointers import NULL_PTR


def fused_probe_ref(keys: torch.Tensor, snap) -> torch.Tensor:
    """Head (latest) row id per key over the snapshot's ragged planes.

    One ``[Q, slots]`` gather + compare per segment, resolved by
    ``max(where(match, ptr, NULL))``, then the first non-NULL candidate
    newest -> oldest.  The head is masked by ``fill``: reserved but
    unwritten arena lanes never answer.
    """
    cands = []
    for blk in snap.blocks:
        b = hashing.bucket_hash(keys, blk.num_buckets).to(torch.int64)
        match = blk.keys[b] == keys[:, None]                 # [Q, slots]
        row_ptr = blk.ptrs[b]
        cands.append(torch.where(match, row_ptr,
                                 torch.full_like(row_ptr, NULL_PTR))
                     .amax(dim=1))
    cands = torch.stack(cands[::-1])                         # newest first
    hit = cands != NULL_PTR
    first = hit.to(torch.int8).argmax(dim=0)
    head = torch.gather(cands, 0, first[None])[0]
    null = torch.full_like(head, NULL_PTR)
    head = torch.where(hit.any(dim=0), head, null)
    return torch.where(head < snap.fill, head, null)


def fused_lookup_ref(keys: torch.Tensor, snap, max_matches: int):
    """Fused probe + chain walk over a Snapshot.

    Returns ``(rows [Q, max_matches] int32 newest-first NULL-padded,
    last [Q] int32)``: ``last`` is the would-be next row id, ``>= 0`` means
    the chain was truncated at ``max_matches``.  Every hop is masked by
    ``fill``, so a pointer into reserved lanes ends the chain there.
    """
    cur = fused_probe_ref(keys, snap)
    prev, fill = snap.prev, snap.fill
    cap = prev.shape[0]
    null = torch.full_like(cur, NULL_PTR)
    rows = []
    for _ in range(max_matches):
        rows.append(cur)
        nxt = torch.where(cur >= 0, prev[cur.clamp(0, cap - 1).long()], null)
        cur = torch.where(nxt < fill, nxt, null)
    return torch.stack(rows, dim=1), cur
