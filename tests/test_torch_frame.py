"""Port parity of the facade: the local ``repro_torch.IndexedFrame``
against ``repro.IndexedFrame`` — the quickstart's steps 1-5 (createIndex,
point lookup, MVCC append, coalesced append, join, planner explain), and
the facade's validation and string-key hashing."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import IndexedFrame as JFrame
from repro.core import Schema as JSchema
from repro.core.hashing import StringDictionary as JDict
from repro_torch import IndexedFrame, Schema
from repro_torch.core.hashing import StringDictionary

SPEC = dict(user_id="int64", score="float32", country="int32")
SCH, JSCH = Schema.of("user_id", **SPEC), JSchema.of("user_id", **SPEC)
# one table size, batch size and query shape across the tests, so the JAX
# side compiles each of its programs once per worker
N, RPB = 700, 64
Q = np.arange(-2, 95, dtype=np.int64)


def users(rng, n, key_range=10_000):
    return {"user_id": rng.integers(0, key_range, n).astype(np.int64),
            "score": rng.random(n).astype(np.float32),
            "country": rng.integers(0, 200, n).astype(np.int32)}


def same(port_out, jax_out):
    if isinstance(port_out, dict):
        assert sorted(port_out) == sorted(jax_out)
        for k in port_out:
            same(port_out[k], jax_out[k])
        return
    np.testing.assert_array_equal(port_out.cpu().numpy(),
                                  np.asarray(jax_out))


def test_quickstart_twin():
    """examples/quickstart.py steps 1-5 (without the append ring) give the
    same answers, versions and explain() strings on both packages."""
    rng = np.random.default_rng(0)
    # 1. createIndex
    base = users(rng, N)
    df = IndexedFrame.from_columns(base, SCH, rows_per_batch=RPB,
                                   device="cpu")
    jdf = JFrame.from_columns(base, JSCH, rows_per_batch=RPB)
    assert df.num_rows() == int(jdf.num_rows()) == N
    assert df.index_nbytes() == int(jdf.index_nbytes())
    assert df.data_nbytes() == int(jdf.data_nbytes())
    # 2. point lookup
    key = np.asarray([int(base["user_id"][0])])
    r, v = df.lookup(key, max_matches=32)
    jr, jv = jdf.lookup(key, max_matches=32)
    same(r, jr)
    same(v, jv)
    # 3. MVCC append: the child sees the row, the parent does not
    one = {"user_id": key.astype(np.int64),
           "score": np.asarray([9.99], np.float32),
           "country": np.asarray([42], np.int32)}
    df2, jdf2 = df.append(one), jdf.append(one)
    assert df2.version == int(jdf2.version) == 1 and df.version == 0
    r2, v2 = df2.lookup(key, max_matches=32)
    same(r2, jdf2.lookup(key, max_matches=32)[0])
    assert int(v2.sum()) == int(v.sum()) + 1
    assert float(r2["score"][0, 0]) == np.float32(9.99)
    same(df.lookup(key, max_matches=32)[0], jr)
    # ... and a list of deltas coalesces into one append
    deltas = [users(rng, n) for n in (20, 10, 10, 10)]
    df3, jdf3 = df2.append(deltas), jdf2.append(deltas)
    assert df3.version == int(jdf3.version) == 2
    # 4. indexed join
    events = {"user_id": rng.choice(base["user_id"], len(Q)).astype(
                  np.int64),
              "event": np.arange(len(Q), dtype=np.int32)}
    b, p, v = df3.join(events, "user_id", max_matches=16)
    jb, jp, jv = jdf3.join(events, "user_id", max_matches=16)
    same(b, jb)
    same(p, jp)
    same(v, jv)
    # 5. the planner names the rule
    assert (df3.plan_join(events, "user_id").explain()
            == jdf3.plan_join(events, "user_id").explain())
    assert (df3.plan_lookup(key).explain()
            == jdf3.plan_lookup(key).explain())
    assert df3.plan_lookup(key).kind == "IndexedLookup"


@pytest.mark.parametrize("layout", ["row", "columnar"])
def test_frame_reads_and_writes_match_jax(layout):
    rng = np.random.default_rng(1)
    base = users(rng, N, key_range=90)
    kw = dict(rows_per_batch=RPB, layout=layout)
    df = IndexedFrame.from_columns(base, SCH, device="cpu", **kw)
    jdf = JFrame.from_columns(base, JSCH, **kw)
    d = users(rng, 50, key_range=90)
    valid = rng.random(50) < 0.7
    df, jdf = df.append(d, valid), jdf.append(d, jnp.asarray(valid))
    d = users(rng, 30, key_range=90)
    df, jdf = df.append(d, mode="segment"), jdf.append(d, mode="segment")
    df, jdf = df.compact(), jdf.compact()
    assert df.version == int(jdf.version) == 3
    for names in (None, ("score",)):
        c, v = df.lookup(Q, max_matches=16, names=names, op="local")
        jc, jv = jdf.lookup(Q, max_matches=16, names=names, op="local")
        same(c, jc)
        same(v, jv)


def test_donated_frame_append_matches_jax():
    rng = np.random.default_rng(2)
    base = users(rng, N, key_range=40)
    df = IndexedFrame.from_columns(base, SCH, rows_per_batch=RPB,
                                   device="cpu")
    jdf = JFrame.from_columns(base, JSCH, rows_per_batch=RPB)
    d = users(rng, 50, key_range=40)
    df2, jdf2 = df.append(d, donate=True), jdf.append(d, donate=True)
    same(df2.lookup(Q, max_matches=16)[0], jdf2.lookup(Q, max_matches=16)[0])
    with pytest.raises(RuntimeError):
        df.lookup(Q)


def test_string_keys_hash_like_jax():
    rng = np.random.default_rng(5)
    cols = users(rng, N)
    cols["user_id"] = rng.choice(np.asarray(["UA", "AA", "DL", "WN"]), N)
    df = IndexedFrame.from_columns(cols, SCH, rows_per_batch=RPB,
                                   dictionary=StringDictionary(),
                                   device="cpu")
    jdf = JFrame.from_columns(cols, JSCH, rows_per_batch=RPB,
                              dictionary=JDict())
    from repro_torch.core.hashing import hash_strings_host
    q = hash_strings_host(np.asarray(["UA", "AA", "XX"]))
    same(df.lookup(q, max_matches=4)[0], jdf.lookup(q, max_matches=4)[0])


@pytest.mark.parametrize("bad", [
    dict(keys=np.arange(3, dtype=np.int32)),
    dict(max_matches=0),
    dict(op="bcast"),
    dict(op="nope"),
])
def test_frame_validation_matches_jax(bad):
    rng = np.random.default_rng(3)
    base = users(rng, N, key_range=10)
    df = IndexedFrame.from_columns(base, SCH, rows_per_batch=RPB,
                                   device="cpu")
    jdf = JFrame.from_columns(base, JSCH, rows_per_batch=RPB)
    keys = bad.pop("keys", np.arange(3, dtype=np.int64))
    with pytest.raises(ValueError) as port_err:
        df.lookup(keys, **bad)
    with pytest.raises(ValueError) as jax_err:
        jdf.lookup(keys, **bad)
    first = str(jax_err.value).split(";")[0].split("(")[0]
    assert str(port_err.value).startswith(first)


def test_keys_on_another_device_are_refused():
    df = IndexedFrame.from_columns(users(np.random.default_rng(4), 30, 9),
                                   SCH, rows_per_batch=16, device="cpu")
    with pytest.raises(ValueError, match="expected cpu"):
        df.lookup(torch.zeros(2, dtype=torch.int64, device="meta"))
