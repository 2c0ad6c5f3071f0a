"""State carried across packages: a ``repro`` table flattened to plain
arrays builds a ``repro_torch`` table (``repro_torch.convert``) that holds
the same state and answers the same reads, and the port's own state
round-trips through the same format."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import Schema as JSchema
from repro.core import append as japp
from repro.core import create_index as jcreate
from repro_torch.convert import (schema_spec, table_from_arrays,
                                 table_to_arrays)
from repro_torch.core import Schema, append, create_index
from repro_torch.core.hashing import split64

SPEC = dict(k="int64", v="float32", tag="int32", w="float64")
SCH, JSCH = Schema.of("k", **SPEC), JSchema.of("k", **SPEC)


def jax_state(t) -> dict:
    """A ``repro`` IndexedTable flattened to the convert format."""
    out = {"version": np.asarray(int(t.version)),
           "fill": np.asarray(t.snapshot.fill)}
    for i, seg in enumerate(t.segments):
        p = f"segments.{i}."
        out[p + "row_base"] = np.asarray(seg.row_base)
        out[p + "bucket_keys"] = np.asarray(seg.index.bucket_keys)
        out[p + "bucket_ptrs"] = np.asarray(seg.index.bucket_ptrs)
        out[p + "prev"] = np.asarray(seg.prev)
        out[p + "valid"] = np.asarray(seg.valid)
        if t.layout == "row":
            out[p + "data"] = np.asarray(seg.data)
        else:
            for name, a in seg.data.items():
                out[p + "data." + name] = np.asarray(a)
    return out


def assert_same_state(port, jt):
    """Every leaf of the port's state equals the JAX table's, and the
    port's snapshot equals JAX's stored snapshot (keys recombined from its
    (hi, lo) planes)."""
    got, want = table_to_arrays(port), jax_state(jt)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    snap, jsnap = port.snapshot, jt.snapshot
    assert snap.bucket_counts == jsnap.bucket_counts
    np.testing.assert_array_equal(snap.prev.numpy(), np.asarray(jsnap.prev))
    assert int(snap.fill) == int(jsnap.fill)
    for b, jb in zip(snap.blocks, jsnap.blocks):
        hi, lo = split64(b.keys)
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jb.key_hi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jb.key_lo))
        np.testing.assert_array_equal(b.ptrs.numpy(), np.asarray(jb.ptrs))


def cols(rng, n, key_range=50, tag0=0):
    return {"k": rng.integers(0, key_range, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "tag": np.arange(tag0, tag0 + n, dtype=np.int32),
            "w": rng.standard_normal(n)}


@pytest.mark.parametrize("layout", ["row", "columnar"])
def test_jax_state_converts_to_port(layout):
    rng = np.random.default_rng(0)
    jt = jcreate(cols(rng, 40), JSCH, rows_per_batch=16, layout=layout,
                 reserve=0)
    for i in range(3):
        jt = japp(jt, cols(rng, 40, tag0=1000 * (i + 1)), mode="segment")
    port = table_from_arrays(jax_state(jt), schema_spec(SCH), device="cpu")
    assert port.layout == layout and port.num_segments == 4
    assert_same_state(port, jt)
    q = np.arange(-2, 55, dtype=np.int64)
    rows, trunc = port.lookup(q, 6)
    jrows, jtrunc = jt.lookup(jnp.asarray(q), 6)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    got = port.gather_rows(rows.clamp_min(0))
    want = jt.gather_rows(jnp.maximum(jrows, 0))
    for name in SCH.names:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("layout", ["row", "columnar"])
def test_port_state_round_trips(layout):
    rng = np.random.default_rng(1)
    t = create_index(cols(rng, 150), SCH, rows_per_batch=16, layout=layout,
                     device="cpu")
    t = append(t, cols(rng, 30, tag0=500))
    back = table_from_arrays(table_to_arrays(t), schema_spec(SCH),
                             device="cpu")
    a, b = table_to_arrays(t), table_to_arrays(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    q = torch.arange(50, dtype=torch.int64)
    for x, y in zip(t.lookup(q, 5), back.lookup(q, 5)):
        assert torch.equal(x, y)
    # the converted table keeps taking appends like the original
    d = cols(rng, 20, tag0=900)
    x, y = append(t, d), append(back, d)
    for k, v in table_to_arrays(x).items():
        np.testing.assert_array_equal(v, table_to_arrays(y)[k], err_msg=k)


def test_convert_rejects_empty_state():
    with pytest.raises(ValueError):
        table_from_arrays({"version": np.asarray(0), "fill": np.asarray(0)},
                          schema_spec(SCH), device="cpu")
