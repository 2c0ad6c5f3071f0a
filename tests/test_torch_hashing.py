"""Port parity: hashing and schema codecs of ``repro_torch`` against
``repro`` on the same inputs, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import hashing as jh
from repro.core import pointers as jptr
from repro.core.hashindex import EMPTY_KEY as J_EMPTY
from repro.core.schema import Schema as JSchema
from repro_torch.core import hashing as th
from repro_torch.core import pointers as tptr
from repro_torch.core.hashindex import EMPTY_KEY
from repro_torch.core.schema import Schema

I64 = np.iinfo(np.int64)
EDGE = np.array([0, 1, -1, I64.min, I64.max, I64.min + 1, I64.max - 1,
                 2**32, -(2**32), 2**31 - 1, -(2**31)], np.int64)


def _keys(seed, n=2000):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(I64.min, I64.max, n,
                                              dtype=np.int64)])


def test_empty_key_matches():
    assert EMPTY_KEY == int(J_EMPTY) == I64.min


@pytest.mark.parametrize("num_buckets", [1, 2, 16, 1024, 2**16, 2**20])
def test_bucket_hash_matches_jax(num_buckets):
    k = _keys(num_buckets)
    want = np.asarray(jh.bucket_hash(jnp.asarray(k), num_buckets))
    got = th.bucket_hash(torch.from_numpy(k), num_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=25, deadline=None)
@given(keys=st.lists(st.integers(I64.min, I64.max), min_size=1,
                     max_size=64),
       log2_nb=st.integers(0, 20))
def test_bucket_hash_property(keys, log2_nb):
    k = np.asarray(keys, np.int64)
    nb = 1 << log2_nb
    np.testing.assert_array_equal(
        th.bucket_hash(torch.from_numpy(k), nb).numpy(),
        np.asarray(jh.bucket_hash(jnp.asarray(k), nb)))


@pytest.mark.parametrize("num_buckets", [0, 3, 12])
def test_bucket_hash_rejects_non_power_of_two(num_buckets):
    with pytest.raises(ValueError):
        th.bucket_hash(torch.zeros(2, dtype=torch.int64), num_buckets)


def test_split64_matches_jax():
    k = _keys(7)
    jhi, jlo = jh.split64(jnp.asarray(k))
    hi, lo = th.split64(torch.from_numpy(k))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


STRINGS = ["", "a", "abc", "héllo wörld", "tail\x00", "in\x00side",
           "carrier-UA", "x" * 40]


@pytest.mark.parametrize("s", STRINGS)
def test_hash_string_host_matches_jax(s):
    assert th.hash_string_host(s) == jh.hash_string_host(s)


def test_hash_strings_host_and_dictionary_match_jax():
    arr = np.asarray(STRINGS * 3, dtype=object)
    np.testing.assert_array_equal(th.hash_strings_host(arr),
                                  jh.hash_strings_host(arr))
    d = th.StringDictionary()
    a = d.encode(arr)
    b = d.encode(arr)
    np.testing.assert_array_equal(a, jh.hash_strings_host(arr))
    np.testing.assert_array_equal(b, a)
    assert d.hashed == len(set(STRINGS)) and d.reused == len(arr)
    assert d.decode(a[:3]) == STRINGS[:3]


# -- schema codecs -----------------------------------------------------------

SPEC = dict(k="int64", f="float32", d="float64", i="int32")


def _special_cols():
    nan_payload = np.array([0x7FF8000000000123], np.int64).view(np.float64)
    snan32 = np.array([0x7FA00001], np.int32).view(np.float32)
    return {
        "k": np.array([I64.min, I64.max, 0, -1, 1, 12345], np.int64),
        "f": np.concatenate([np.array([-0.0, np.inf, -np.inf, 1.5, 0.0],
                                      np.float32), snan32]),
        "d": np.concatenate([np.array([-0.0, np.nan, -np.inf, 2.5e300, 0.0],
                                      np.float64), nan_payload]),
        "i": np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0,
                       -1, 7, 8], np.int32),
    }


def test_encode_rows_matches_jax_words():
    cols = _special_cols()
    sch, jsch = Schema.of("k", **SPEC), JSchema.of("k", **SPEC)
    got = sch.encode_rows({k: torch.from_numpy(v) for k, v in cols.items()})
    want = np.asarray(jsch.encode_rows({k: jnp.asarray(v)
                                        for k, v in cols.items()}))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(SPEC))
def test_decode_rows_round_trip_bitwise(name):
    cols = _special_cols()
    sch = Schema.of("k", **SPEC)
    words = sch.encode_rows({k: torch.from_numpy(v)
                             for k, v in cols.items()})
    back = sch.decode_rows(words)[name].numpy()
    bits = np.dtype(f"i{back.dtype.itemsize}")
    np.testing.assert_array_equal(back.view(bits), cols[name].view(bits))
    # a batched [..., W] word tensor decodes the same, and so does a
    # one-row slice (its stride is not the row width)
    back2 = sch.decode_rows(words.reshape(2, 3, -1))[name].reshape(-1)
    np.testing.assert_array_equal(back2.numpy().view(bits),
                                  cols[name].view(bits))
    back3 = sch.decode_rows(words[2:3])[name].numpy()
    np.testing.assert_array_equal(back3.view(bits), cols[name][2:3].view(bits))


def test_schema_validation_differs_from_jax():
    """A deliberate difference (ROADMAP.md section C): a malformed schema
    raises ValueError here, where the JAX package asserts."""
    with pytest.raises(AssertionError):
        JSchema.of("missing", k="int64")
    with pytest.raises(ValueError):
        Schema.of("missing", k="int64")
    with pytest.raises(ValueError):
        Schema.of("k", k="int16")
    sch, jsch = Schema.of("k", **SPEC), JSchema.of("k", **SPEC)
    assert sch.width_words == jsch.width_words == 6
    assert sch.offset_words("d") == jsch.offset_words("d") == 3
    assert sch.row_bytes() == jsch.row_bytes() == 24


def test_pointer_pack_unpack_match_jax():
    rng = np.random.default_rng(11)
    batch = rng.integers(0, 1 << 10, 50).astype(np.int32)
    off = rng.integers(0, 1 << 12, 50).astype(np.int32)
    packed = tptr.pack(torch.from_numpy(batch), torch.from_numpy(off),
                       log2_rows_per_batch=12)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jptr.pack(batch, off,
                                             log2_rows_per_batch=12)))
    ptrs = np.concatenate([packed.numpy(), [-1, -1]]).astype(np.int32)
    for got, want in zip(tptr.unpack(torch.from_numpy(ptrs),
                                     log2_rows_per_batch=12),
                         jptr.unpack(ptrs, log2_rows_per_batch=12)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tptr.is_null(torch.from_numpy(ptrs)).tolist() == list(
        np.asarray(jptr.is_null(ptrs)))
    assert tptr.NULL_PTR == int(jptr.NULL_PTR)
