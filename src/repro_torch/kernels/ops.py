"""Public entry points of the lookup kernel.

``fused_lookup`` is the multi-segment read hot path: probe + chain walk
over a table's Snapshot.  It dispatches on the device of the query
tensor: a CUDA tensor goes to the hand-written kernel
(``hash_probe.fused_lookup_tiles``), which launches or raises; a CPU
tensor goes to the plain PyTorch version (``ref.fused_lookup_ref``).
Nothing looks at whether a card exists.

The wrappers own the EMPTY-key mask: EMPTY query keys never match.
Kernel launches are counted where they happen, in
``hash_probe.LAUNCHES``.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashindex import EMPTY_KEY
from repro_torch.core.pointers import NULL_PTR
from repro_torch.kernels import hash_probe, ref


def fused_lookup(query_keys: torch.Tensor, snap, *, max_matches: int):
    """[Q] int64 keys against a Snapshot -> (rows [Q, max_matches] int32
    global row ids newest-first NULL-padded, truncated [Q] bool)."""
    q = query_keys
    if q.device != snap.device:
        raise ValueError(f"query keys on {q.device}, snapshot on "
                         f"{snap.device}")
    if q.device.type == "cuda":
        rows, last = hash_probe.fused_lookup_tiles(
            q, snap, max_matches=max_matches)
    elif q.device.type == "cpu":
        rows, last = ref.fused_lookup_ref(q, snap, max_matches)
    else:
        raise ValueError(f"no lookup path for device {q.device}")
    empty = q == EMPTY_KEY
    rows = rows.masked_fill(empty[:, None], NULL_PTR)
    truncated = (last >= 0) & ~empty
    return rows, truncated


def fused_probe(query_keys: torch.Tensor, snap) -> torch.Tensor:
    """Head (latest) row id per key over a Snapshot's planes.  [Q] int32.
    A one-hop fused lookup: ``rows[:, 0]`` is the head."""
    rows, _ = fused_lookup(query_keys, snap, max_matches=1)
    return rows[:, 0]
