"""The indexed lookup and join operators (paper §III-C).

* ``indexed_lookup`` — the paper's point lookup: probe + chain walk +
                       gather over the table's Snapshot.
* ``indexed_join``   — the indexed side is the pre-built build side;
                       probe rows are looked up against it.

Output contract: every query or probe row yields ``max_matches`` slots,
newest first, padded and flagged by ``valid``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pointers import NULL_PTR
from repro_torch.core.table import IndexedTable
from repro_torch.device import on_device


def check_max_matches(max_matches: int):
    """Reject non-positive match-slot counts."""
    if max_matches <= 0:
        raise ValueError(
            f"max_matches must be a positive match-slot count, "
            f"got {max_matches}")


def as_int64_keys(keys, device: torch.device) -> torch.Tensor:
    """``keys`` as an int64 tensor on ``device``; any other dtype is
    rejected."""
    dtype = keys.dtype if isinstance(keys, torch.Tensor) \
        else np.asarray(keys).dtype
    if dtype not in (torch.int64, np.dtype(np.int64)):
        raise ValueError(
            f"query keys must be int64 (got {dtype}); keys are int64 at "
            f"every API boundary — pre-hash string keys at ingest "
            f"(hashing.hash_string_host) and cast narrower integer keys "
            f"explicitly")
    return on_device(keys, torch.int64, device)


def indexed_lookup(table: IndexedTable, keys, *, max_matches: int,
                   names=None):
    """Point lookup: rows for each key, newest-first.  Returns
    (cols dict with shape [Q, max_matches], valid [Q, max_matches])."""
    check_max_matches(max_matches)
    keys = as_int64_keys(keys, table.device)
    rids, _ = table.lookup(keys, max_matches)
    valid = rids != NULL_PTR
    cols = table.gather_rows(rids.clamp_min(0), names=names)
    return cols, valid


def indexed_join(table: IndexedTable, probe_cols: dict, probe_key: str, *,
                 max_matches: int, names=None):
    """Equi-join: ``table`` (indexed) is the build side; ``probe_cols``
    rows probe it.

    Returns (build_cols [Q, M], probe_cols broadcast [Q, M], valid [Q, M]);
    the broadcast probe columns are expanded views, not copies.
    """
    keys = on_device(probe_cols[probe_key], torch.int64, table.device)
    build_cols, valid = indexed_lookup(table, keys, max_matches=max_matches,
                                       names=names)
    m = valid.shape[1]
    probe_b = {}
    for k, v in probe_cols.items():
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v), device=table.device)
        probe_b[k] = v[:, None].expand(v.shape[0], m)
    return build_cols, probe_b, valid
