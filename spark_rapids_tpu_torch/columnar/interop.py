"""Build a ColumnarBatch from per-column numpy arrays taken as they are.

This is how data crosses from another columnar engine (or from a
spark_rapids_tpu batch, via `np.asarray` of its columns) into this package
without being re-derived: the arrays already carry their padding, and the
narrow shadows are taken as given, so both sides run on identical bytes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    resolve_device)


def batch_from_arrays(fields: Sequence[tuple[str, str]],
                      data: Sequence[np.ndarray],
                      validity: Sequence[np.ndarray], num_rows: int,
                      narrow: Optional[Sequence[Optional[np.ndarray]]] = None,
                      device="cuda") -> ColumnarBatch:
    """`fields` is (name, type name) per column ("int32", "float64",
    "date32", ...); `data`, `validity` and `narrow` (None where a column
    has no 32-bit shadow) are arrays of the full padded capacity."""
    dev = resolve_device(device)
    if not (len(fields) == len(data) == len(validity)):
        raise ValueError("fields, data and validity differ in length")
    narrow = list(narrow) if narrow is not None else [None] * len(fields)
    schema = T.Schema(tuple(T.Field(n, T.from_name(t)) for n, t in fields))
    cols = []
    for f, d, v, nw in zip(schema.fields, data, validity, narrow):
        d = np.asarray(d)
        if d.dtype != f.dtype.storage_dtype:
            raise TypeError(f"column {f.name}: {d.dtype} data for type "
                            f"{f.dtype}")
        cols.append(ColumnVector(
            f.dtype, torch.from_numpy(np.array(d)).to(dev),
            torch.from_numpy(np.array(v, dtype=bool)).to(dev),
            None if nw is None else torch.from_numpy(np.array(nw)).to(dev)))
    return ColumnarBatch(schema, cols, int(num_rows))
