"""Port parity of MVCC versions: divergent children of one parent,
coalesced deltas, donated appends, flat data carried through appends, the
segment-looped reference twins of the fused reads, and random append
sequences — each bit-identical to ``repro`` on the same inputs (helpers
shared with tests/test_torch_table.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import coalesce_deltas as jcoalesce
from repro_torch.convert import table_to_arrays
from repro_torch.core import append, coalesce_deltas
from test_torch_convert import JSCH, SCH, assert_same_state, cols
from test_torch_table import (LAYOUTS, Q, assert_same_reads, make_pair,
                              step)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_divergent_children_stay_independent(layout):
    """Paper Listing 2: two non-donated appends on one parent each see
    only their own delta, and the parent sees neither."""
    rng = np.random.default_rng(4)
    parent = make_pair(4, layout=layout)
    before = table_to_arrays(parent[0])
    da, db = cols(rng, 13, tag0=5000), cols(rng, 40, tag0=7000)
    a, b = step(parent, da), step(parent, db)
    a2 = step(a, cols(rng, 13, tag0=9000))
    for child in (a, b, a2, parent):
        assert_same_state(*child)
    assert_same_reads(*a2)
    for k, v in table_to_arrays(parent[0]).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    tags_a = set(a[0].gather_rows(torch.arange(200))["tag"].tolist())
    assert 5000 in tags_a and 7000 not in tags_a


@pytest.mark.parametrize("layout", LAYOUTS)
def test_coalesced_deltas_match_jax_and_sequential(layout):
    rng = np.random.default_rng(5)
    pair = make_pair(5, layout=layout)
    sizes = [13, 9, 9, 9]             # coalesced: one 40-row delta
    deltas = [cols(rng, n, tag0=100 * (i + 1)) for i, n in enumerate(sizes)]
    valids = [None, rng.random(9) < 0.5, None, rng.random(9) < 0.5]
    c, v = coalesce_deltas(deltas, SCH, valids)
    jc, jv = jcoalesce(deltas, JSCH, valids)
    np.testing.assert_array_equal(v, jv)
    co = step(pair, c, v)
    assert_same_state(*co)
    assert co[0].version == pair[0].version + 1
    seq = pair[0]
    for d, m in zip(deltas, valids):
        seq = append(seq, d, m)
    for x, y in zip(co[0].lookup(Q, 12), seq.lookup(Q, 12)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        coalesce_deltas([], SCH)
    with pytest.raises(ValueError):
        coalesce_deltas(deltas, SCH, valids[:2])


def test_coalesce_keeps_tensors_on_their_device():
    d = {k: torch.as_tensor(v) for k, v in
         cols(np.random.default_rng(0), 4).items()}
    c, v = coalesce_deltas([d, d], SCH)
    assert isinstance(c["k"], torch.Tensor) and c["k"].shape == (8,)
    assert v is None


@pytest.mark.parametrize("layout", LAYOUTS)
def test_donated_append_consumes_parent(layout):
    rng = np.random.default_rng(6)
    t1, _ = make_pair(6, layout=layout)
    t2, _ = make_pair(6, layout=layout)
    d = cols(rng, 13)
    a, b = append(t1, d), append(t2, d, donate=True)
    for k, v in table_to_arrays(a).items():
        np.testing.assert_array_equal(v, table_to_arrays(b)[k], err_msg=k)
    with pytest.raises(RuntimeError, match="consumed"):
        t2.lookup(Q, 2)
    with pytest.raises(RuntimeError, match="consumed"):
        append(t2, d)
    t1.lookup(Q, 2)                     # the non-donated parent lives


@pytest.mark.parametrize("layout", LAYOUTS)
def test_flat_data_carried_through_appends(layout):
    """A table that materialized its flat data keeps it current through
    arena appends on a multi-segment table."""
    rng = np.random.default_rng(8)
    port, jt = make_pair(8, n=40, layout=layout, reserve=0)
    port, jt = step((port, jt), cols(rng, 40, tag0=100))   # promotes
    port, jt = port.with_flat_data(), jt.with_flat_data()
    for i in range(2):
        port, jt = step((port, jt), cols(rng, 13, tag0=1000 * (i + 2)))
        assert port.snapshot.data is not None
        assert_same_reads(port, jt)
    flat = port.snapshot.data
    want = jt.snapshot.data
    if layout == "row":
        np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    else:
        for k in flat:
            np.testing.assert_array_equal(flat[k].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_reads_match_segment_looped_twins(layout):
    rng = np.random.default_rng(9)
    port, _ = make_pair(9, n=40, layout=layout, reserve=0)
    for i in range(3):
        port = append(port, cols(rng, 13, tag0=100 * (i + 1)),
                      mode="segment")
    rows, trunc = port.lookup(Q, 7)
    rrows, rtrunc = port.lookup_ref(Q, 7)
    assert torch.equal(rows, rrows) and torch.equal(trunc, rtrunc)
    assert torch.equal(port.probe_latest(Q), port.probe_latest_ref(Q))
    rids = torch.arange(-3, port.capacity + 3, dtype=torch.int32)
    assert torch.equal(port.gather_prev(rids), port.gather_prev_ref(rids))
    a, b = port.gather_rows(rids), port.gather_rows_ref(rids)
    for name in SCH.names:
        assert torch.equal(a[name], b[name])


OPS = st.sampled_from(["arena", "donate", "segment", "masked"])


@settings(max_examples=6, deadline=None)
@given(ops=st.lists(OPS, min_size=1, max_size=3),
       seed=st.integers(0, 2**16))
def test_append_sequences_property(ops, seed):
    """Random sequences of append kinds stay bit-identical to JAX."""
    rng = np.random.default_rng(seed)
    pair = make_pair(seed)
    for i, op in enumerate(ops):
        d = cols(rng, 13, tag0=100 * (i + 1))
        if op == "segment":
            pair = step(pair, d, mode="segment")
        elif op == "masked":
            pair = step(pair, d, rng.random(13) < 0.6)
        else:
            pair = step(pair, d, donate=op == "donate")
        assert_same_state(*pair)
    assert_same_reads(*pair)


def test_donation_consumes_every_version_holding_the_tail():
    """A child made by promotion holds its parent's tail as a sealed
    segment; donating the parent consumes that child too — in JAX its
    buffers are deleted, here reading it raises (never a silent read of
    rows written after it was made)."""
    rng = np.random.default_rng(14)
    port, jt = make_pair(14, n=40, reserve=0)
    big = cols(rng, 40, tag0=500)
    child, jchild = append(port, big), step((port, jt), big)[1]
    assert child.num_segments == 2
    small = cols(rng, 3, tag0=900)      # fits the 8 spare lanes
    step((port, jt), small, donate=True)
    for t in (child, port):
        with pytest.raises(RuntimeError, match="consumed"):
            t.lookup(Q, 2)
    with pytest.raises(RuntimeError):
        np.asarray(jchild.lookup(Q, 2)[0])
