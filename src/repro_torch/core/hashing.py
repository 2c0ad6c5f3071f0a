"""Key hashing for the Indexed DataFrame.

``bucket_hash`` places a key in a bucket of the dense index.  It is the
splitmix64 mix followed by a golden-ratio multiply whose *high* bits pick
the bucket, bit-identical to the JAX package's ``bucket_hash`` and to the
same arithmetic inside the lookup kernel (kernels/csrc/fused_lookup.cu).

PyTorch has no right shift on ``torch.uint64`` on the CPU, so the mix runs
in int64: a multiply wraps exactly as the unsigned one does, and a logical
right shift is an arithmetic shift followed by a mask.

The string helpers are host-side numpy: string keys are FNV-1a hashed to
int64 at ingest (the paper hashes strings for its cTrie).
"""

from __future__ import annotations

import numpy as np
import torch

_U64 = 1 << 64


def _signed(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - _U64 if c >= 1 << 63 else c


# splitmix64 / Fibonacci constants, as int64 bit patterns.
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)
_GOLDEN = _signed(0x9E3779B97F4A7C15)


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by ``0 < n < 64``."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    return x ^ _lsr(x, 31)


def bucket_hash(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Bucket id in [0, num_buckets) as int32; num_buckets must be 2**k."""
    if num_buckets <= 0 or num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets must be 2**k, got {num_buckets}")
    keys = torch.as_tensor(keys, dtype=torch.int64)
    lg = num_buckets.bit_length() - 1
    if lg == 0:
        # the shift would be 64: XLA's shift gives 0 there, and so do we
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    # high bits of the golden-ratio product (low bits correlate with the
    # partition hash's modulus for small shard counts)
    h = _splitmix64(keys) * _GOLDEN
    return _lsr(h, 64 - lg).to(torch.int32)


def split64(x: torch.Tensor):
    """int64 tensor -> (hi, lo) int32 planes (high and low 32-bit words)."""
    x = torch.as_tensor(x, dtype=torch.int64)
    hi = (x >> 32).to(torch.int32)
    lo = (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
    return hi, lo


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def hash_string_host(s: str) -> int:
    """Host-side FNV-1a of a string key -> int64."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return _signed(h)


def hash_strings_host(strings) -> np.ndarray:
    """Vectorized ``hash_string_host`` over a batch -> int64 array.

    The byte-matrix walk applies the same FNV-1a step per position, masked
    so each string stops at its own byte length.  numpy's S dtype cannot
    hold trailing NUL bytes, so strings ending in NUL take the scalar path.
    """
    arr = np.asarray(strings, dtype=object).reshape(-1)
    n = arr.shape[0]
    if n == 0:
        return np.empty((0,), np.int64)
    blist = [s.encode("utf-8") for s in arr]
    lens = np.array([len(b) for b in blist], dtype=np.int64)
    nul = np.array([b.endswith(b"\x00") for b in blist])
    out = np.full((n,), _FNV_OFFSET, np.uint64)
    maxlen = int(lens.max())
    if maxlen:
        mat = (np.array(blist, dtype=f"S{maxlen}")
               .view(np.uint8).reshape(n, maxlen).astype(np.uint64))
        with np.errstate(over="ignore"):
            for j in range(maxlen):
                live = j < lens
                step = (out ^ mat[:, j]) * _FNV_PRIME
                out = np.where(live, step, out)
    if nul.any():
        out[nul] = [np.uint64(hash_string_host(s) & 0xFFFFFFFFFFFFFFFF)
                    for s in arr[nul]]
    return out.astype(np.int64)


class StringDictionary:
    """Dictionary-encode cache over ``hash_strings_host``.

    Keeps the vocabulary -> int64 code table across batches: each
    ``encode`` probes the table per row and FNV-hashes only strings never
    seen before.  Codes are exactly ``hash_strings_host``'s; ``decode``
    keeps the reverse map.  ``reused``/``hashed`` count rows answered from
    the table and strings that paid the byte walk.
    """

    def __init__(self):
        self._codes: dict = {}     # str -> int64 code
        self._strings: dict = {}   # int64 code -> str (reverse map)
        self.hashed = 0
        self.reused = 0

    def __len__(self) -> int:
        return len(self._codes)

    def encode(self, strings) -> np.ndarray:
        """Batch of strings -> int64 key codes, hashing only novel
        vocabulary."""
        arr = np.asarray(strings, dtype=object).reshape(-1)
        n = arr.shape[0]
        if n == 0:
            return np.empty((0,), np.int64)
        get = self._codes.get
        out = [get(s) for s in arr]
        miss = [i for i, c in enumerate(out) if c is None]
        if miss:
            uniq = np.unique(arr[miss])
            for s, h in zip(uniq, hash_strings_host(uniq)):
                self._codes[s] = np.int64(h)
                self._strings[int(h)] = s
            self.hashed += len(uniq)
            for i in miss:
                out[i] = self._codes[arr[i]]
        self.reused += n - len(miss)
        return np.asarray(out, np.int64)

    def decode(self, codes) -> list:
        """int64 codes -> the original strings (None for unknown codes)."""
        return [self._strings.get(int(c)) for c in np.asarray(codes)]
