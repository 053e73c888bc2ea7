"""Random schemas and batches with nulls for fuzz tests (port of
spark_rapids_tpu/utils/fuzzer.py): every one of the ten types, NaN and
+-Infinity among the floats, drawn from a numpy Generator so that one
seed gives both packages the same values.
"""
from __future__ import annotations

import string
from typing import Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

#: the types the fuzzer draws from: the whole type matrix
FUZZ_TYPES = (T.BOOL, T.INT8, T.INT16, T.INT32, T.INT64, T.FLOAT32,
              T.FLOAT64, T.DATE32, T.TIMESTAMP_US, T.STRING)


def random_schema(rng: np.random.Generator, num_cols: Optional[int] = None,
                  types: Sequence = FUZZ_TYPES) -> T.Schema:
    n = num_cols or int(rng.integers(1, 7))
    return T.Schema(tuple(
        T.Field(f"c{i}", types[int(rng.integers(0, len(types)))])
        for i in range(n)))


def _random_values(rng: np.random.Generator, dtype: T.DataType, n: int
                   ) -> np.ndarray:
    if dtype == T.BOOL:
        return rng.integers(0, 2, n).astype(bool)
    if dtype in (T.INT8, T.INT16, T.INT32, T.INT64):
        info = np.iinfo(dtype.storage_dtype)
        # within the int8 range, so casts and concats across types stay
        # exact
        return rng.integers(max(info.min, -100), min(info.max, 100),
                            n).astype(dtype.storage_dtype)
    if dtype in (T.FLOAT32, T.FLOAT64):
        vals = rng.normal(scale=100.0, size=n).astype(dtype.storage_dtype)
        special = rng.random(n)
        vals = np.where(special < 0.05, np.nan, vals)
        vals = np.where((special >= 0.05) & (special < 0.08), np.inf, vals)
        vals = np.where((special >= 0.08) & (special < 0.10), -np.inf,
                        vals)
        return vals.astype(dtype.storage_dtype)
    if dtype == T.DATE32:
        return rng.integers(-3650, 3650, n).astype(np.int32)
    if dtype == T.TIMESTAMP_US:
        return rng.integers(0, 4_000_000_000_000_000, n).astype(np.int64)
    if dtype.is_string:
        alphabet = string.ascii_letters + string.digits + " _-"
        return np.array(
            ["".join(rng.choice(list(alphabet),
                                size=int(rng.integers(0, 12))))
             for _ in range(n)], dtype=object)
    raise ValueError(f"fuzzer cannot generate {dtype}")


def random_batch(rng: np.random.Generator, schema: Optional[T.Schema] = None,
                 num_rows: Optional[int] = None, null_fraction: float = 0.15,
                 device="cuda") -> ColumnarBatch:
    schema = schema or random_schema(rng)
    n = int(rng.integers(0, 200)) if num_rows is None else num_rows
    data, validity = {}, {}
    for f in schema.fields:
        data[f.name] = _random_values(rng, f.dtype, n)
        valid = rng.random(n) >= null_fraction
        if f.dtype.is_string:
            data[f.name][~valid] = None
        validity[f.name] = valid
    return ColumnarBatch.from_numpy(data, schema, validity, device=device)


def random_batches(rng: np.random.Generator, schema: T.Schema, count: int,
                   **kw) -> list[ColumnarBatch]:
    return [random_batch(rng, schema, **kw) for _ in range(count)]
