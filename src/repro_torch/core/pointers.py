"""Packed row pointers for the Indexed DataFrame.

The paper packs ``(row_batch_number, offset_within_batch, prev_row_size)``
into dense 64-bit integers (paper §III-C).  Here, as in the JAX package, a
pointer is a *flat int32 row id* over the ordered list of fixed-capacity
row batches::

    row_id = batch_id * rows_per_batch + offset      (NULL = -1)

``rows_per_batch`` is a power of two, so batch/offset recovery is a
shift/mask.  int32 addresses 2**31 rows per partition.
"""

from __future__ import annotations

import torch

NULL_PTR = -1
PTR_DTYPE = torch.int32


def pack(batch_id, offset, *, log2_rows_per_batch: int) -> torch.Tensor:
    """Pack (batch_id, offset) into a flat int32 row pointer."""
    batch_id = torch.as_tensor(batch_id, dtype=PTR_DTYPE)
    offset = torch.as_tensor(offset, dtype=PTR_DTYPE)
    return (batch_id << log2_rows_per_batch) | offset


def unpack(ptr, *, log2_rows_per_batch: int):
    """Unpack a flat row pointer into (batch_id, offset).

    NULL pointers unpack to (-1, -1) so downstream gathers can mask on
    either component.
    """
    ptr = torch.as_tensor(ptr, dtype=PTR_DTYPE)
    mask = ptr >= 0
    null = torch.full_like(ptr, NULL_PTR)
    batch_id = torch.where(mask, ptr >> log2_rows_per_batch, null)
    offset = torch.where(mask, ptr & ((1 << log2_rows_per_batch) - 1), null)
    return batch_id, offset


def is_null(ptr):
    return ptr < 0
