"""Spark-exact Murmur3 x86_32 row hashing in plain torch ops (port of
spark_rapids_tpu/ops/murmur3.py).

Spark's `Murmur3Hash` (seed 42), which `HashPartitioning` uses:

  hash = 42
  for each column:  hash = hash_col(value, seed=hash)   # null: unchanged

  int/bool/date -> hashInt(v)
  long          -> hashLong(v)   (two 32-bit words)
  float  -> hashInt(floatToIntBits(f))   with -0.0 normalized to 0.0
  double -> hashLong(doubleToLongBits(d)) with -0.0 normalized
  string -> hashUnsafeBytes(utf8): 4-byte LE words, then per-byte tail
            (bytes are SIGNED in the tail), fmix with total length

torch has no uint32 arithmetic, so every 32-bit word lives in an int64
tensor in [0, 2^32); multiplies split the constant into 16-bit halves,
so no product leaves the int64 range.  Doubles hash their exact bit
pattern (`view(torch.int64)`), which is Spark's behaviour; the
reference's frexp decomposition flushes subnormals to zero instead, so
the two differ on subnormal doubles only.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector

C1 = 0xCC9E2D51
C2 = 0x1B873593
SPARK_SEED = 42
_M32 = 0xFFFFFFFF


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32): both partial products stay
    below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    return _mul(_rotl(_mul(k1, C1), 15), C2)


def _mix_h1(h1, k1):
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def hash_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt of 32-bit words `v` (int64 in [0, 2^32)) under `seed`."""
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def hash_long(lo: torch.Tensor, hi: torch.Tensor,
              seed: torch.Tensor) -> torch.Tensor:
    h1 = _mix_h1(seed, _mix_k1(lo))
    h1 = _mix_h1(h1, _mix_k1(hi))
    return _fmix(h1, 8)


def _long_words(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    v = v.to(torch.int64)
    return v & _M32, (v >> 32) & _M32


def hash_column(col: ColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Chain one column into the row hash; null rows keep the seed."""
    dt = col.dtype
    if dt.is_string:
        h = _hash_string(col, seed)
    elif dt.id in (T.TypeId.BOOL, T.TypeId.INT8, T.TypeId.INT16,
                   T.TypeId.INT32, T.TypeId.DATE32):
        # Spark hashes a byte or a short as its sign-extended int
        h = hash_int(col.data.to(torch.int64) & _M32, seed)
    elif dt.id in (T.TypeId.INT64, T.TypeId.TIMESTAMP_US):
        # an int32 shadow sign-extends to the same two words
        src = col.narrow if col.narrow is not None else col.data
        h = hash_long(*_long_words(src), seed)
    elif dt.id == T.TypeId.FLOAT32:
        f = torch.where(col.data == 0.0, 0.0, col.data)  # -0f -> 0f
        bits = f.view(torch.int32).to(torch.int64) & _M32
        # Java's canonical NaN float: 0x7FC00000
        bits = torch.where(torch.isnan(f), 0x7FC00000, bits)
        h = hash_int(bits, seed)
    elif dt.id == T.TypeId.FLOAT64:
        d = torch.where(col.data == 0.0, 0.0, col.data)  # -0.0 -> 0.0
        bits = d.view(torch.int64)
        # Java's canonical NaN double: 0x7FF8000000000000
        bits = torch.where(torch.isnan(d), 0x7FF8 << 48, bits)
        h = hash_long(*_long_words(bits), seed)
    else:
        raise TypeError(f"unhashable type {dt}")
    return torch.where(col.validity, h, seed)


def _hash_string(col: ColumnVector, seed: torch.Tensor) -> torch.Tensor:
    """Words and tail bytes past the longest string change no row's
    hash, so the longest length (read back once) bounds the loops."""
    cc = col.char_cap
    data = col.data.to(torch.int64)            # [cap, cc]
    lens = col.lengths.to(torch.int64)
    longest = min(int(lens.max()), cc) if lens.numel() else 0
    h1 = seed
    aligned = (lens // 4) * 4
    for base in range(0, longest - longest % 4, 4):
        word = (data[:, base] | (data[:, base + 1] << 8)
                | (data[:, base + 2] << 16) | (data[:, base + 3] << 24))
        h1 = torch.where(base + 4 <= aligned, _mix_h1(h1, _mix_k1(word)),
                         h1)
    # tail: at most 3 bytes (len % 4), each mixed as a SIGNED byte
    for t in range(min(3, longest)):
        bpos = (aligned + t).clamp(0, cc - 1)
        byte = torch.gather(data, 1, bpos[:, None])[:, 0]
        sbyte = torch.where(byte >= 128, byte - 256, byte) & _M32
        h1 = torch.where(aligned + t < lens, _mix_h1(h1, _mix_k1(sbyte)),
                         h1)
    return _fmix(h1, lens & _M32)


def _seed(cap: int, seed: int, device) -> torch.Tensor:
    return torch.full((cap,), seed & _M32, dtype=torch.int64, device=device)


def _to_int32(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def murmur3_row_hash(cols: list[ColumnVector],
                     seed: int = SPARK_SEED) -> torch.Tensor:
    """Spark Murmur3Hash(columns...) as int32."""
    h = _seed(cols[0].capacity, seed, cols[0].device)
    for c in cols:
        h = hash_column(c, h)
    return _to_int32(h)


def partition_ids(cols: list[ColumnVector], num_partitions: int
                  ) -> torch.Tensor:
    """Spark HashPartitioning: pmod(murmur3(keys), n), int32."""
    h = murmur3_row_hash(cols).to(torch.int64)
    return torch.remainder(h, num_partitions).to(torch.int32)
