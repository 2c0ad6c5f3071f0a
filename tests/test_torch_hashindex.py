"""Port parity: the dense hash index of ``repro_torch`` against ``repro``
— bulk build planes, backward-pointer pairs, arena insert plans, probes
and chain walks, bit for bit on the same seeded inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashindex as jhix
from repro_torch.core import hashindex as hix

I64 = np.iinfo(np.int64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _build_inputs(seed, n, key_range, frac_valid=0.8, row_base=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-key_range, key_range, n).astype(np.int64)
    keys[:3] = [I64.max, I64.min + 1, 0][:min(3, n)]
    valid = rng.random(n) < frac_valid
    rows = (np.arange(n) + row_base).astype(np.int32)
    return keys, rows, valid


@pytest.mark.parametrize("seed,n,key_range,nb,slots", [
    (0, 200, 50, 16, 8),        # dup-heavy, fits
    (1, 300, 10_000, 16, 8),    # distinct-heavy, overflows 16 buckets
    (2, 257, 100, 64, 4),       # odd length, 4 slots
    (3, 64, 3, 1, 8),           # one bucket (hash shift of 64)
    (4, 1000, 400, 128, 8),
])
def test_build_arrays_matches_jax(seed, n, key_range, nb, slots):
    keys, rows, valid = _build_inputs(seed, n, key_range, row_base=96)
    want = jhix._build_arrays(jnp.asarray(keys), jnp.asarray(rows),
                              jnp.asarray(valid), nb, slots)
    got = hix._build_arrays(_t(keys), _t(rows), _t(valid), nb, slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_index_retry_matches_jax(seed):
    """The overflow-doubling retry lands on the same bucket count."""
    keys, rows, _ = _build_inputs(seed, 150, 10**9)
    j_idx, j_rows, j_vals = jhix.build_index(jnp.asarray(keys),
                                             jnp.asarray(rows),
                                             num_buckets=8)
    idx, p_rows, p_vals = hix.build_index(_t(keys), _t(rows),
                                          num_buckets=8)
    assert idx.num_buckets == j_idx.num_buckets > 8
    np.testing.assert_array_equal(idx.bucket_keys.numpy(),
                                  np.asarray(j_idx.bucket_keys))
    np.testing.assert_array_equal(idx.bucket_ptrs.numpy(),
                                  np.asarray(j_idx.bucket_ptrs))
    np.testing.assert_array_equal(p_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(p_vals.numpy(), np.asarray(j_vals))
    assert idx.nbytes == j_idx.nbytes


def test_build_index_gives_up():
    keys = np.arange(4096, dtype=np.int64)
    with pytest.raises(RuntimeError, match="overflowed"):
        hix.build_index(_t(keys), _t(keys.astype(np.int32)), num_buckets=16,
                        slots=1, max_retries=2)


@pytest.mark.parametrize("n_keys", [0, 1, 100, 5000, 10**6])
def test_suggest_num_buckets_matches_jax(n_keys):
    assert hix.suggest_num_buckets(n_keys) == jhix.suggest_num_buckets(n_keys)


@pytest.mark.parametrize("seed,n_delta,nb", [(0, 40, 16), (1, 200, 16),
                                             (2, 64, 64), (3, 10, 1)])
def test_arena_insert_plan_matches_jax(seed, n_delta, nb):
    """Placement into a live table: existing keys reuse their slot, new
    keys take occupancy + rank, overflow is counted."""
    rng = np.random.default_rng(seed)
    keys, rows, valid = _build_inputs(seed, 120, 150)
    bk, _, _, _, _ = jhix._build_arrays(jnp.asarray(keys), jnp.asarray(rows),
                                        jnp.asarray(valid), nb, 8)
    heads = np.concatenate([keys[:n_delta // 2],
                            rng.integers(-300, 300, n_delta - n_delta // 2)]
                           ).astype(np.int64)
    is_head = rng.random(n_delta) < 0.7
    heads = np.where(is_head, heads, I64.min)
    jflat, jovf = jax.jit(jhix.arena_insert_plan)(bk, jnp.asarray(heads),
                                         jnp.asarray(is_head))
    flat, ovf = hix.arena_insert_plan(_t(np.asarray(bk)), _t(heads),
                                      _t(is_head))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert int(ovf) == int(jovf)


def test_probe_and_chain_walk_match_jax():
    keys, rows, valid = _build_inputs(5, 400, 60)
    j_idx, j_rows, j_vals = jhix.build_index(jnp.asarray(keys),
                                             jnp.asarray(rows),
                                             valid=jnp.asarray(valid))
    idx, p_rows, p_vals = hix.build_index(_t(keys), _t(rows),
                                          valid=_t(valid))
    q = np.concatenate([keys[:50], [I64.min, I64.max, 10**12]]).astype(
        np.int64)
    heads = hix.probe(idx, _t(q))
    np.testing.assert_array_equal(heads.numpy(),
                                  np.asarray(jax.jit(jhix.probe)(j_idx,
                                                        jnp.asarray(q))))
    prev = np.full(400, -1, np.int32)
    ok = np.asarray(j_rows) < 400
    prev[np.asarray(j_rows)[ok]] = np.asarray(j_vals)[ok]
    for m in (1, 3, 9):
        jr, jt = jax.jit(jhix.chain_walk, static_argnums=2)(jnp.asarray(prev), jnp.asarray(
            np.asarray(heads)), m)
        r, t = hix.chain_walk(_t(prev), heads, m)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(
            hix.match_counts(_t(prev), heads, m).numpy(),
            np.asarray(jax.jit(jhix.match_counts, static_argnums=2)(
                jnp.asarray(prev),
                                         jnp.asarray(np.asarray(heads)), m)))


def test_lexsort2_matches_numpy():
    rng = np.random.default_rng(3)
    prim = rng.integers(0, 5, 300).astype(np.int64)
    sec = rng.permutation(300).astype(np.int64)
    np.testing.assert_array_equal(hix.lexsort2(_t(sec), _t(prim)).numpy(),
                                  np.lexsort((sec, prim)))
