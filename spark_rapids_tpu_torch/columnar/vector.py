"""Column vectors: validity-masked torch tensors padded to a bucketed
capacity (port of spark_rapids_tpu/columnar/vector.py).

A batch's logical row count lives beside its columns; kernels derive the
row mask from `arange(capacity) < num_rows`, so padded rows never count.
Strings are a uint8[capacity, char_cap] byte matrix plus int32 lengths,
char_cap bucketed like the row capacity.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

MIN_CAPACITY = 32
MIN_CHAR_CAP = 8


def bucket_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def bucket_char_cap(n: int) -> int:
    return bucket_capacity(max(n, 1), MIN_CHAR_CAP)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  "cuda" needs a card: without
    one this raises rather than falling back to the CPU; pass
    device="cpu" to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _f32_shadow(x_f64: torch.Tensor) -> torch.Tensor:
    """FLOAT64 -> f32 narrow shadow with explicit overflow semantics:
      - monotone: x <= y  =>  shadow(x) <= shadow(y)
      - finiteness preserved: finite f64 -> finite f32 (clamped to
        +-f32max past the f32 range), +-inf -> +-inf, NaN -> NaN
      - sign preserved (incl. -0.0)."""
    n32 = x_f64.to(torch.float32)
    over = torch.isinf(n32) & torch.isfinite(x_f64)
    fmax = torch.full_like(x_f64, float(torch.finfo(torch.float32).max))
    return torch.where(over, torch.copysign(fmax, x_f64).to(torch.float32),
                       n32)


def _upload(arr: np.ndarray, capacity: int, dev) -> torch.Tensor:
    """`arr` on `dev`, zero-padded to `capacity` rows; the padding is
    made on the device, so the host copies nothing.  A read-only array
    (a pandas copy-on-write view) is only ever read: the result is a
    copy of it."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(arr)
    if src.shape[0] == capacity:
        out = src.to(dev)
        return out.clone() if out is src and not arr.flags.writeable \
            else out
    out = torch.zeros((capacity,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=dev)
    out[:src.shape[0]].copy_(src)
    return out


@dataclasses.dataclass
class ColumnVector:
    """One column: `data` padded to capacity, `validity` True where
    non-null.

    `narrow` is an optional 32-bit shadow of `data`: an int32 copy of an
    INT64 column whose values fit int32 (exact), or an f32 copy of a
    FLOAT64 column (lossy; read only by lanes that already carry the
    variableFloatAgg tolerance).  For STRING columns `data` is
    uint8[capacity, char_cap] and `lengths` int32[capacity] (0 on null
    rows); otherwise `lengths` is None."""
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor
    narrow: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def char_cap(self) -> int:
        if not self.dtype.is_string:
            raise TypeError(f"char_cap of a {self.dtype} column")
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: Optional[T.DataType] = None,
                   validity: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   device="cuda") -> "ColumnVector":
        """Upload one column, deriving its 32-bit shadow as above."""
        dev = resolve_device(device)
        values = np.asarray(values)
        if dtype is None:
            dtype = T.from_numpy_dtype(values.dtype)
        n = len(values)
        cap = capacity or bucket_capacity(n)
        if validity is None:
            if values.dtype == object:
                validity = np.array([v is not None for v in values], bool)
            else:  # NaN is a value, not null (Spark)
                validity = np.ones(n, bool)
        validity = np.asarray(validity, bool)
        valid_t = _upload(validity[:n], cap, dev)
        if dtype.is_string:
            data, lengths = strings_to_bytes(values, validity[:n])
            return ColumnVector(dtype, _upload(data, cap, dev), valid_t,
                                lengths=_upload(lengths, cap, dev))
        host = values.astype(dtype.storage_dtype, copy=False)
        data = _upload(host, cap, dev)
        narrow = None
        if dtype.id == T.TypeId.INT64:
            # the zero padding fits int32, so the live values decide
            lo, hi = (host.min(), host.max()) if n else (0, 0)
            if np.iinfo(np.int32).min <= lo and hi <= np.iinfo(np.int32).max:
                narrow = data.to(torch.int32)
        elif dtype.id == T.TypeId.FLOAT64:
            narrow = _f32_shadow(data)
        return ColumnVector(dtype, data, valid_t, narrow)

    def to_numpy(self, num_rows: int) -> tuple[np.ndarray, np.ndarray]:
        """(values, validity) trimmed to num_rows; strings decode to an
        object array of str (None for nulls)."""
        validity = self.validity[:num_rows].cpu().numpy()
        if self.dtype.is_string:
            raw = self.data[:num_rows].cpu().numpy()
            lens = self.lengths[:num_rows].cpu().numpy()
            out = np.empty(num_rows, object)
            for i in range(num_rows):
                out[i] = (raw[i, :lens[i]].tobytes().decode("utf-8",
                                                           "replace")
                          if validity[i] else None)
            return out, validity
        return self.data[:num_rows].cpu().numpy(), validity

    def _map(self, fn) -> "ColumnVector":
        """Apply `fn` to every row-indexed tensor of the column."""
        return ColumnVector(
            self.dtype, fn(self.data), fn(self.validity),
            None if self.narrow is None else fn(self.narrow),
            None if self.lengths is None else fn(self.lengths))

    def with_capacity(self, capacity: int) -> "ColumnVector":
        if capacity == self.capacity:
            return self
        if capacity < self.capacity:
            return self._map(lambda x: x[:capacity])
        extra = capacity - self.capacity
        return self._map(lambda x: torch.cat(
            [x, x.new_zeros((extra,) + tuple(x.shape[1:]))]))

    def gather(self, indices: torch.Tensor,
               index_valid: Optional[torch.Tensor] = None
               ) -> "ColumnVector":
        """Take rows by index, indices clamped into range; `index_valid`
        marks the rows kept."""
        idx = indices.clamp(0, self.capacity - 1).to(torch.int64)
        out = self._map(lambda x: x[idx])
        if index_valid is not None:
            out.validity = out.validity & index_valid
        return out


def gather_columns_grouped(columns, order, valid):
    """Reorder every column by `order`, live output rows marked by `valid`.
    (The TPU version batches all 4-byte streams into one stacked gather
    because its random access costs per row; a GPU gathers each column
    at full bandwidth, so this is one gather per column.)"""
    return [c.gather(order, valid) for c in columns]


def _pad_chars(v: ColumnVector, cc: int) -> ColumnVector:
    if v.char_cap == cc:
        return v
    pad = v.data.new_zeros((v.capacity, cc - v.char_cap))
    return ColumnVector(v.dtype, torch.cat([v.data, pad], dim=1),
                        v.validity, lengths=v.lengths)


def align_char_caps(a: ColumnVector, b: ColumnVector
                    ) -> tuple[ColumnVector, ColumnVector]:
    """Pad two string vectors to a shared char capacity (for concat and
    compare)."""
    cc = max(a.char_cap, b.char_cap)
    return _pad_chars(a, cc), _pad_chars(b, cc)


def _encode_rows(values, valid) -> list:
    """Per-row UTF-8 encode, as the reference does it: str encodes,
    bytes pass, anything else encodes its str(); null rows are b""."""
    return [(v.encode("utf-8") if isinstance(v, str)
             else bytes(v) if isinstance(v, (bytes, bytearray))
             else str(v).encode("utf-8")) if ok else b""
            for v, ok in zip(values, valid)]


def _bytes_matrix(enc: list) -> tuple[np.ndarray, np.ndarray]:
    n = len(enc)
    lens = np.fromiter((len(e) for e in enc), np.int32, count=n)
    cc = bucket_char_cap(int(lens.max()) if n else 0)
    data = np.zeros((n, cc), np.uint8)
    if n and lens.any():
        flat = np.frombuffer(b"".join(enc), np.uint8)
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        off = np.arange(len(flat), dtype=np.int64) - np.repeat(starts, lens)
        data.reshape(-1)[row * cc + off] = flat
    return data, lens


def strings_to_bytes(values, valid) -> tuple[np.ndarray, np.ndarray]:
    """(uint8[n, char_cap] bytes, int32[n] lengths) of n host values, the
    same bytes and lengths as encoding each row alone (`_encode_rows`).
    Values that are all str (or null) with few distinct ones, as flag
    and code columns are, encode each distinct value once and gather its
    bytes by the factorized codes; anything else takes the per-row
    encode."""
    import pandas as pd
    values = np.asarray(values)
    valid = np.asarray(valid, bool)
    n = len(values)
    if n and pd.api.types.infer_dtype(values[valid], skipna=False) in (
            "string", "empty"):
        codes, uniques = pd.factorize(np.where(valid, values, ""))
        if len(uniques) * 8 <= n:
            data, lens = _bytes_matrix(_encode_rows(
                uniques, np.ones(len(uniques), bool)))
            return data[codes], lens[codes]
    return _bytes_matrix(_encode_rows(values, valid))


#: how many column validities fit one packed int32 bitmask
VMASK_BITS = 30


def validity_bit_assignment(columns) -> dict:
    """{ordinal: bit} for the first VMASK_BITS non-string columns
    (strings resolve their validity inside their own gather).  Pure
    dtype metadata, so the side that packs and the side that unpacks
    get the same assignment by construction."""
    bits: dict = {}
    for ci, c in enumerate(columns):
        if c.dtype.is_string:
            continue
        if len(bits) >= VMASK_BITS:
            break
        bits[ci] = len(bits)
    return bits


def pack_validity_bits(columns):
    """`validity_bit_assignment` and the packed int32 mask itself, one
    bit per column per row: ({ordinal: bit}, mask or None)."""
    bits = validity_bit_assignment(columns)
    if not bits:
        return bits, None
    packed = torch.zeros(columns[0].validity.shape[0], dtype=torch.int32,
                         device=columns[0].device)
    for ci, bit in bits.items():
        packed = packed | (columns[ci].validity.to(torch.int32) << bit)
    return bits, packed


def gather_narrowest(c: ColumnVector, indices: torch.Tensor,
                     valid: torch.Tensor) -> ColumnVector:
    """Gather a non-string column whose validity the caller has already
    resolved (`valid`).  An int64 column with an int32 shadow gathers
    only the shadow and widens it exactly; anything else gathers its
    data and its shadow, if it has one.  Indices are clamped into
    range."""
    idx = indices.clamp(0, c.capacity - 1).to(torch.int64)
    if c.narrow is not None and c.dtype.id == T.TypeId.INT64:
        nd = c.narrow[idx]
        return ColumnVector(c.dtype, nd.to(c.data.dtype), valid, nd)
    narrow = None if c.narrow is None else c.narrow[idx]
    return ColumnVector(c.dtype, c.data[idx], valid, narrow)
