"""Port parity: the lookup kernel's plain PyTorch version
(``repro_torch.kernels.ref``) and its dispatcher (``kernels.ops``) against
the JAX package's ``ops.fused_lookup`` — through the Pallas kernel in
interpret mode for up to 4 segments, and through its vectorized oracle for
1-20 segments.  Rows and truncation flags are bit-identical.  The CUDA
kernel itself is held to the same plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.snapshot import FlatBlock as JFlatBlock
from repro.core.snapshot import Snapshot as JSnapshot
from repro.kernels import ops as jops
from repro_torch.core import Schema, append, create_index
from repro_torch.core.hashing import split64
from repro_torch.core.snapshot import strip_data
from repro_torch.kernels import hash_probe, ops, ref

I64 = np.iinfo(np.int64)
SCH = Schema.of("k", k="int64", v="float32", tag="int32")


def _cols(rng, n, key_range, tag0=0):
    return {"k": rng.integers(0, key_range, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "tag": np.arange(tag0, tag0 + n, dtype=np.int32)}


def _port_table(seed, n_segments, key_range=60):
    """A segment-mode table: one delta segment per append, delta sizes
    mixed so the segments' bucket counts differ."""
    rng = np.random.default_rng(seed)
    t = create_index(_cols(rng, 300, key_range), SCH, rows_per_batch=16,
                     reserve=0, device="cpu")
    for i in range(n_segments - 1):
        n = int(rng.choice([5, 40, 130]))
        t = append(t, _cols(rng, n, key_range, 1000 * (i + 1)),
                   mode="segment")
    assert t.num_segments == n_segments
    return t


def _jax_snapshot(snap):
    """The same planes as a JAX Snapshot (keys split to (hi, lo))."""
    blocks = []
    for b in snap.blocks:
        hi, lo = split64(b.keys)
        blocks.append(JFlatBlock(jnp.asarray(hi.numpy()),
                                 jnp.asarray(lo.numpy()),
                                 jnp.asarray(b.ptrs.numpy()),
                                 b.num_buckets))
    return JSnapshot(blocks=tuple(blocks), prev=jnp.asarray(snap.prev.numpy()),
                     data=None, fill=jnp.asarray(int(snap.fill), jnp.int32),
                     bucket_counts=snap.bucket_counts, layout=snap.layout)


def _queries(seed, key_range=60, n=70):
    """Duplicate-heavy present keys, absent keys, EMPTY and extremes; an
    odd count so no block size divides it."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, key_range, n),
                           rng.integers(key_range, 3 * key_range, 9),
                           [I64.min, I64.max, -1, I64.min + 1]]
                          ).astype(np.int64)


def _check(snap, q, max_matches, *, use_kernel):
    rows, trunc = ops.fused_lookup(torch.from_numpy(q), snap,
                                   max_matches=max_matches)
    jrows, jtrunc = jops.fused_lookup(jnp.asarray(q), _jax_snapshot(snap),
                                      max_matches=max_matches,
                                      use_kernel=use_kernel, interpret=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    return rows, trunc


@pytest.mark.parametrize("n_segments", [1, 2, 4])
@pytest.mark.parametrize("max_matches", [1, 8])
def test_fused_lookup_matches_pallas_interpret(n_segments, max_matches):
    t = _port_table(n_segments, n_segments)
    _check(t.snapshot, _queries(n_segments), max_matches, use_kernel=True)


@pytest.mark.parametrize("n_segments", [1, 2, 8, 13, 20])
@pytest.mark.parametrize("max_matches", [1, 8, 64])
def test_fused_lookup_matches_jax_oracle(n_segments, max_matches):
    t = _port_table(100 + n_segments, n_segments)
    rows, trunc = _check(t.snapshot, _queries(n_segments), max_matches,
                         use_kernel=False)
    if max_matches == 1:
        assert bool(trunc.any())          # duplicate-heavy keys truncate


def _garbage_snapshot(seed):
    """Lanes at or above ``fill`` hold garbage; some written lanes and one
    bucket pointer are forged to point into them."""
    t = _port_table(seed, 3)
    snap = t.snapshot
    cap = snap.capacity
    fill = cap - 60
    rng = np.random.default_rng(seed)
    prev = snap.prev.clone()
    prev[fill:] = torch.from_numpy(rng.integers(-3, cap, cap - fill)
                                   .astype(np.int32))
    forged = torch.from_numpy(rng.choice(fill, 25, replace=False))
    prev[forged] = torch.from_numpy(rng.integers(fill, cap, 25)
                                    .astype(np.int32))
    blk = snap.blocks[0]
    ptrs = blk.ptrs.clone()
    i, j = map(int, torch.nonzero(ptrs >= 0)[0])
    ptrs[i, j] = fill + 3
    blocks = (dataclasses.replace(blk, ptrs=ptrs),) + snap.blocks[1:]
    return dataclasses.replace(snap, blocks=blocks, prev=prev,
                               fill=torch.tensor(fill, dtype=torch.int32))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fill_mask_on_garbage_lanes(use_kernel):
    snap = _garbage_snapshot(7)
    rows, _ = _check(snap, _queries(7), 16, use_kernel=use_kernel)
    assert int(rows.max()) < int(snap.fill)


def test_empty_keys_never_match_and_probe_is_first_hop():
    t = _port_table(3, 2)
    q = torch.from_numpy(_queries(3))
    rows, trunc = ops.fused_lookup(q, t.snapshot, max_matches=4)
    empty = q == I64.min
    assert bool((rows[empty] == -1).all()) and not bool(trunc[empty].any())
    np.testing.assert_array_equal(ops.fused_probe(q, t.snapshot).numpy(),
                                  rows[:, 0].numpy())
    raw, last = ref.fused_lookup_ref(q, t.snapshot, 4)
    np.testing.assert_array_equal(raw[~empty].numpy(), rows[~empty].numpy())


def test_strip_data_keeps_the_probe_planes():
    t = _port_table(6, 2).with_flat_data()
    assert t.snapshot.data is not None
    bare = strip_data(t.snapshot)
    assert bare.data is None and bare.blocks is t.snapshot.blocks
    assert strip_data(bare) is bare
    q = torch.from_numpy(_queries(6))
    for a, b in zip(ops.fused_lookup(q, bare, max_matches=5),
                    ops.fused_lookup(q, t.snapshot, max_matches=5)):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    t = _port_table(4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        hash_probe.fused_lookup_tiles(torch.zeros(3, dtype=torch.int64),
                                      t.snapshot, max_matches=2)


def test_dispatch_refuses_mixed_devices():
    t = _port_table(5, 1)
    with pytest.raises(ValueError):
        ops.fused_lookup(torch.zeros(3, dtype=torch.int64, device="meta"),
                         t.snapshot, max_matches=2)
