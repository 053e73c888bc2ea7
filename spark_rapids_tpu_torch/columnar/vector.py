"""Column vectors: validity-masked torch tensors padded to a bucketed
capacity (port of spark_rapids_tpu/columnar/vector.py, numeric types only).

A batch's logical row count lives beside its columns; kernels derive the
row mask from `arange(capacity) < num_rows`, so padded rows never count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

MIN_CAPACITY = 32


def bucket_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


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


def _f32_shadow(x_f64: np.ndarray) -> np.ndarray:
    """FLOAT64 -> f32 narrow shadow with explicit overflow semantics:
      - monotone: x <= y  =>  shadow(x) <= shadow(y)
      - finiteness preserved: finite f64 -> finite f32 (clamped to
        +-f32max past the f32 range), +-inf -> +-inf, NaN -> NaN
      - sign preserved (incl. -0.0)."""
    with np.errstate(over="ignore"):
        n32 = x_f64.astype(np.float32)
    over = np.isinf(n32) & np.isfinite(x_f64)
    if over.any():
        fmax = np.finfo(np.float32).max
        n32 = np.where(over, np.copysign(fmax, x_f64).astype(np.float32),
                       n32)
    return n32


def _pad_to(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    return np.pad(arr, (0, capacity - n))


@dataclasses.dataclass
class ColumnVector:
    """One column: `data` padded to capacity, `validity` True where
    non-null.

    `narrow` is an optional 32-bit shadow of `data`: an int32 copy of an
    INT64 column whose values fit int32 (exact), or an f32 copy of a
    FLOAT64 column (lossy; read only by lanes that already carry the
    variableFloatAgg tolerance)."""
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor
    narrow: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

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
            validity = np.ones(n, bool)  # NaN is a value, not null (Spark)
        validity = _pad_to(np.asarray(validity, bool), cap)
        safe = _pad_to(values.astype(dtype.storage_dtype, copy=False), cap)
        narrow = None
        if dtype.id == T.TypeId.INT64 and len(safe):
            lo, hi = safe.min(), safe.max()
            if np.iinfo(np.int32).min <= lo and hi <= np.iinfo(np.int32).max:
                narrow = safe.astype(np.int32)
        elif dtype.id == T.TypeId.FLOAT64:
            narrow = _f32_shadow(safe)
        return ColumnVector(
            dtype, torch.from_numpy(np.ascontiguousarray(safe)).to(dev),
            torch.from_numpy(validity).to(dev),
            None if narrow is None
            else torch.from_numpy(np.ascontiguousarray(narrow)).to(dev))

    def to_numpy(self, num_rows: int) -> tuple[np.ndarray, np.ndarray]:
        """(values, validity) trimmed to num_rows."""
        return (self.data[:num_rows].cpu().numpy(),
                self.validity[:num_rows].cpu().numpy())

    def with_capacity(self, capacity: int) -> "ColumnVector":
        if capacity == self.capacity:
            return self
        if capacity < self.capacity:
            return ColumnVector(
                self.dtype, self.data[:capacity],
                self.validity[:capacity],
                None if self.narrow is None else self.narrow[:capacity])
        extra = capacity - self.capacity

        def pad(x):
            return torch.cat([x, x.new_zeros(extra)])
        return ColumnVector(self.dtype, pad(self.data), pad(self.validity),
                            None if self.narrow is None
                            else pad(self.narrow))

    def gather(self, indices: torch.Tensor,
               index_valid: Optional[torch.Tensor] = None
               ) -> "ColumnVector":
        """Take rows by index, indices clamped into range; `index_valid`
        marks the rows kept."""
        idx = indices.clamp(0, self.capacity - 1).to(torch.int64)
        validity = self.validity[idx]
        if index_valid is not None:
            validity = validity & index_valid
        return ColumnVector(self.dtype, self.data[idx], validity,
                            None if self.narrow is None
                            else self.narrow[idx])


def gather_columns_grouped(columns, order, valid):
    """Reorder every column by `order`, live output rows marked by `valid`.
    (The TPU version batches all 4-byte streams into one stacked gather
    because its random access costs per row; a GPU gathers each column
    at full bandwidth, so this is one gather per column.)"""
    return [c.gather(order, valid) for c in columns]
