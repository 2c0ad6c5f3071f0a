"""Fixed-width table schemas + row-wise / columnar storage codecs.

Two layouts, as in the JAX package:

* ``row``      — each row is ``width_words`` 4-byte words in one int32
                 tensor; int64/float64 take two words (low word first),
                 float32 is bit-reinterpreted.
* ``columnar`` — one typed tensor per column.

Word conversion is ``Tensor.view(dtype)``: a reinterpretation of the same
bytes, so -0.0, NaN payloads and the int64 extremes round-trip bit for
bit.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "int32": (torch.int32, 1),
    "int64": (torch.int64, 2),
    "float32": (torch.float32, 1),
    "float64": (torch.float64, 2),
}


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    dtype: str  # key in _DTYPES

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype][0]

    @property
    def width_words(self) -> int:
        return _DTYPES[self.dtype][1]


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered fixed-width columns; ``key`` names the indexed column."""

    columns: tuple[Column, ...]
    key: str

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError("duplicate column names")
        if self.key not in names:
            raise ValueError(f"key column {self.key!r} not in schema")
        for c in self.columns:
            if c.dtype not in _DTYPES:
                raise ValueError(f"column {c.name!r}: unsupported dtype "
                                 f"{c.dtype!r}")

    @staticmethod
    def of(key: str, **cols: str) -> "Schema":
        return Schema(tuple(Column(n, d) for n, d in cols.items()), key)

    @property
    def width_words(self) -> int:
        return sum(c.width_words for c in self.columns)

    @property
    def names(self):
        return tuple(c.name for c in self.columns)

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def offset_words(self, name: str) -> int:
        off = 0
        for c in self.columns:
            if c.name == name:
                return off
            off += c.width_words
        raise KeyError(name)

    def row_bytes(self) -> int:
        return self.width_words * 4

    # -- codecs --------------------------------------------------------------

    def encode_rows(self, cols: dict) -> torch.Tensor:
        """dict[name -> [N] typed tensor] -> [N, width_words] int32."""
        parts = []
        n = None
        for c in self.columns:
            a = torch.as_tensor(cols[c.name], dtype=c.torch_dtype)
            n = a.shape[0] if n is None else n
            if a.shape != (n,):
                raise ValueError(f"column {c.name}: bad shape "
                                 f"{tuple(a.shape)}")
            parts.append(a.contiguous().view(torch.int32).reshape(
                n, c.width_words))
        return torch.cat(parts, dim=1)

    def decode_rows(self, words: torch.Tensor, names=None) -> dict:
        """[..., width_words] int32 -> dict[name -> [...] typed tensor]."""
        names = names or self.names
        out = {}
        for name in names:
            c = self.column(name)
            off = self.offset_words(name)
            w = words[..., off:off + c.width_words]
            if c.width_words > 1:
                # reinterpreting two words as one needs a packed, aligned
                # copy (a slice's offset or strides may not be)
                w = w.clone(memory_format=torch.contiguous_format)
            out[name] = w.view(c.torch_dtype)[..., 0]
        return out

    def key_from_words(self, words):
        return self.decode_rows(words, names=(self.key,))[self.key]
