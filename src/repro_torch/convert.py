"""Carry an indexed table's state across packages as plain arrays.

``table_from_arrays`` builds the port's ``IndexedTable`` from a dict of
numpy arrays and a schema spec — the state of a table of the JAX package
(or of this one, flattened by ``table_to_arrays``).  The dict holds:

* ``version`` and ``fill`` — 0-d integers;
* per segment ``i``: ``segments.{i}.row_base`` (0-d), ``.bucket_keys``
  ``[nb, slots] int64``, ``.bucket_ptrs`` ``[nb, slots] int32``,
  ``.prev`` ``[cap] int32``, ``.valid`` ``[cap] bool``, and the rows:
  ``.data`` ``[batches, rows_per_batch, words] int32`` for the row layout,
  or ``.data.{column}`` ``[batches, rows_per_batch]`` per column for the
  columnar layout.

The schema spec is ``{"key": name, "columns": [[name, dtype], ...]}``.
Nothing here imports the JAX package: the caller flattens its table.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashindex import HashIndex
from repro_torch.core.schema import Column, Schema
from repro_torch.core.snapshot import snapshot_from_segments
from repro_torch.core.table import IndexedTable, Segment
from repro_torch.device import resolve_device


def schema_from_spec(spec: dict) -> Schema:
    return Schema(tuple(Column(str(n), str(d)) for n, d in spec["columns"]),
                  str(spec["key"]))


def schema_spec(schema: Schema) -> dict:
    return {"key": schema.key,
            "columns": [[c.name, c.dtype] for c in schema.columns]}


def table_from_arrays(arrays: dict, spec: dict, *,
                      device=None) -> IndexedTable:
    """The port's table over the given state, on ``device`` (``None``
    means the CUDA card).  Every array is copied to the device."""
    dev = resolve_device(device)
    schema = schema_from_spec(spec)
    layout = "row" if "segments.0.data" in arrays else "columnar"

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=dev)

    segments = []
    i = 0
    while f"segments.{i}.prev" in arrays:
        p = f"segments.{i}."
        keys = t(p + "bucket_keys", torch.int64)
        nb, slots = keys.shape
        if layout == "row":
            data = t(p + "data", torch.int32)
        else:
            data = {c.name: t(p + "data." + c.name, c.torch_dtype)
                    for c in schema.columns}
        segments.append(Segment(
            data=data,
            index=HashIndex(keys, t(p + "bucket_ptrs", torch.int32),
                            int(nb), int(slots)),
            prev=t(p + "prev", torch.int32),
            valid=t(p + "valid", torch.bool),
            row_base=int(arrays[p + "row_base"]), layout=layout))
        i += 1
    if not segments:
        raise ValueError("no segments.0.* arrays in the state dict")
    rows_per_batch = (segments[0].data.shape[1] if layout == "row"
                      else next(iter(segments[0].data.values())).shape[1])
    snap = snapshot_from_segments(tuple(segments), layout, schema=schema)
    snap = type(snap)(blocks=snap.blocks, prev=snap.prev, data=None,
                      fill=t("fill", torch.int32).reshape(()),
                      layout=layout)
    return IndexedTable(segments=tuple(segments), snapshot=snap,
                        version=int(arrays["version"]), schema=schema,
                        rows_per_batch=int(rows_per_batch), layout=layout,
                        slots=segments[0].index.slots)


def table_to_arrays(table: IndexedTable) -> dict:
    """The table's state as a dict of numpy arrays (the format above)."""
    out = {"version": np.asarray(table.version, np.int64),
           "fill": table.fill.cpu().numpy()}
    for i, seg in enumerate(table.segments):
        p = f"segments.{i}."
        out[p + "row_base"] = np.asarray(seg.row_base, np.int64)
        out[p + "bucket_keys"] = seg.index.bucket_keys.cpu().numpy()
        out[p + "bucket_ptrs"] = seg.index.bucket_ptrs.cpu().numpy()
        out[p + "prev"] = seg.prev.cpu().numpy()
        out[p + "valid"] = seg.valid.cpu().numpy()
        if table.layout == "row":
            out[p + "data"] = seg.data.cpu().numpy()
        else:
            for name, a in seg.data.items():
                out[p + "data." + name] = a.cpu().numpy()
    return out
