"""Port parity: append sequences on ``repro_torch`` tables against the
same sequences on ``repro`` tables, for both layouts.  After every step
the whole state is bit-identical (bucket planes, prev, valid, row data,
fill, version) and so are the reads (rows, truncation, decoded columns).
Covers arena appends (with donation and valid masks), segment mode,
promotion, the compaction threshold and compaction; MVCC divergence and
coalescing are in tests/test_torch_append.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import append as japp
from repro.core import compact as jcompact
from repro.core import create_index as jcreate
from repro_torch.core import append, compact, create_index
from repro_torch.core import table as table_mod
from test_torch_convert import JSCH, SCH, assert_same_state, cols

LAYOUTS = ["row", "columnar"]
I64 = np.iinfo(np.int64)
Q = np.concatenate([np.arange(-1, 52), [I64.min, I64.max]]).astype(np.int64)


def assert_same_reads(port, jt, max_matches=12):
    rows, trunc = port.lookup(Q, max_matches)
    jrows, jtrunc = jt.lookup(jnp.asarray(Q), max_matches)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    got = port.gather_rows(rows.clamp_min(0))
    want = jt.gather_rows(jnp.maximum(jrows, 0))
    for name in SCH.names:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    assert port.num_rows() == int(jt.num_rows())


def make_pair(seed, n=100, layout="row", reserve=None, rpb=16):
    c = cols(np.random.default_rng(seed), n)
    return (create_index(c, SCH, rows_per_batch=rpb, layout=layout,
                         reserve=reserve, device="cpu"),
            jcreate(c, JSCH, rows_per_batch=rpb, layout=layout,
                    reserve=reserve))


def step(pair, delta, valid=None, **kw):
    port, jt = pair
    return (append(port, delta, valid, **kw),
            japp(jt, delta, None if valid is None else jnp.asarray(valid),
                 **kw))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_arena_sequence_with_promotion(layout):
    """In-place arena appends (with and without donation and with valid
    masks) until the tail fills and promotes, then appends into the new
    tail."""
    rng = np.random.default_rng(1)
    pair = make_pair(1, layout=layout)
    assert_same_state(*pair)
    cap0 = pair[0].capacity
    for i, n in enumerate([13, 40, 40, 40, 13, 40]):
        valid = (rng.random(n) < 0.75) if i % 3 == 1 else None
        pair = step(pair, cols(rng, n, tag0=1000 * (i + 1)), valid,
                    donate=(i % 2 == 1))
        assert_same_state(*pair)
    assert_same_reads(*pair)
    assert pair[0].num_segments == 2 and pair[0].capacity > 2 * cap0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_mode_and_compaction_threshold(layout):
    rng = np.random.default_rng(2)
    pair = make_pair(2, n=40, layout=layout, reserve=0)
    for i in range(3):                  # the third trips the threshold
        pair = step(pair, cols(rng, 13, tag0=100 * (i + 1)), mode="segment",
                    compact_threshold=3)
        assert_same_state(*pair)
    assert pair[0].num_segments <= 3
    port, jt = compact(pair[0]), jcompact(pair[1])
    assert port.num_segments == 1 and port.version == int(jt.version)
    assert_same_state(port, jt)
    assert_same_reads(port, jt)


def test_arena_promotion_trips_threshold():
    rng = np.random.default_rng(3)
    pair = make_pair(3, n=40, reserve=0)
    for i in range(3):                  # the second trips the threshold
        pair = step(pair, cols(rng, 40, tag0=100 * (i + 1)),
                    compact_threshold=2)
        assert pair[0].num_segments <= 2
        assert_same_state(*pair)
    assert_same_reads(*pair)


def test_sparse_valid_delta_promotes():
    rng = np.random.default_rng(7)
    pair = make_pair(7, n=40, reserve=0)
    valid = np.zeros(40, bool)
    valid[::3] = True                   # 14 valid rows > 8 spare lanes
    pair = step(pair, cols(rng, 40, tag0=1000), valid)
    assert pair[0].num_segments == 2
    assert_same_state(*pair)
    assert_same_reads(*pair)


def test_fill_masks_reserved_lanes():
    port, jt = make_pair(10)
    fill, cap = int(port.fill), port.capacity
    assert fill < cap
    forged = torch.tensor([fill, cap - 1, fill - 1, 0], dtype=torch.int32)
    got = port.gather_rows(forged)
    want = jt.gather_rows(jnp.asarray(forged.numpy()))
    for name in SCH.names:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["k"][0] == 0 and got["v"][1] == 0
    assert port.gather_prev(forged[:2]).tolist() == [-1, -1]


def test_capacity_policy_matches_jax():
    from repro.core import table as jtable
    for n, rpb in [(1, 16), (100, 16), (4096, 4096), (5000, 64)]:
        assert table_mod.capacity_class(n, rpb) == jtable.capacity_class(
            n, rpb)
        assert table_mod.pad_to_batches(n, rpb) == jtable.pad_to_batches(
            n, rpb)


def test_compact_returns_reserved_arena():
    port, jt = make_pair(11, n=40, reserve=0)
    port2, jt2 = compact(port, reserve=500), jcompact(jt, reserve=500)
    assert port2.capacity == jt2.capacity >= 500
    assert port2.version == int(jt2.version) == 1
    assert_same_state(port2, jt2)


def test_nbytes_match_jax():
    rng = np.random.default_rng(12)
    pair = make_pair(12)
    pair = step(pair, cols(rng, 40, tag0=100))
    for logical in (False, True):
        assert pair[0].index_nbytes(logical=logical) == int(
            pair[1].index_nbytes(logical=logical))
        assert pair[0].data_nbytes(logical=logical) == int(
            pair[1].data_nbytes(logical=logical))


def test_append_rejects_bad_mode():
    port, _ = make_pair(13)
    with pytest.raises(ValueError):
        append(port, cols(np.random.default_rng(0), 3), mode="ring")
