"""ColumnarBatch: the unit of execution (port of
spark_rapids_tpu/columnar/batch.py).

A batch's row count may be a Python int or a device scalar still being
computed; reading `.num_rows` of a device count syncs, while
`.num_rows_i32` / `.row_mask()` / `.maybe_nonempty()` stay on the device.
A batch may be SPARSE: `sparse` is a device bool mask selecting its live
rows (filters defer compaction; sparse-aware consumers fold the mask into
their own row masking, everyone else calls `.dense()`).

Batches also carry deferred validity `checks` (device bool scalars)
registered by optimistic fast paths; see utils/checks.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (
    MIN_CAPACITY, MIN_CHAR_CAP, ColumnVector, _pad_chars, _upload,
    bucket_capacity, resolve_device, strings_from_offsets,
    strings_to_offsets)


class ColumnarBatch:
    """schema + padded device columns + (possibly lazy) row count."""

    __slots__ = ("schema", "columns", "_rows", "checks", "sparse")

    def __init__(self, schema: T.Schema, columns: list[ColumnVector],
                 num_rows, checks: tuple = (), sparse=None):
        self.schema = schema
        self.columns = columns
        self.sparse = sparse
        if num_rows is None:
            if sparse is None:
                raise ValueError("num_rows=None needs a sparse mask")
            num_rows = sparse.sum().to(torch.int32)
        self._rows = num_rows
        self.checks = tuple(checks)
        if len(self.columns) != len(self.schema.fields):
            raise ValueError(f"{len(self.columns)} columns for "
                             f"{len(self.schema.fields)} fields")
        caps = {c.capacity for c in self.columns}
        if len(caps) > 1:
            raise ValueError(f"ragged capacities {caps}")

    def dense(self) -> "ColumnarBatch":
        """Compact a sparse batch to the dense rows-first layout."""
        if self.sparse is None:
            return self
        from spark_rapids_tpu_torch.ops.sort_encode import masked_positions
        cap = self.capacity
        n = self.num_rows_i32
        idx = masked_positions(self.sparse, cap, fill_value=cap - 1)
        valid = torch.arange(cap, device=self.device) < n
        cols = [c.gather(idx, valid) for c in self.columns]
        rows = self._rows if isinstance(self._rows, int) else n
        return ColumnarBatch(self.schema, cols, rows, self.checks)

    # -- row count (lazy) ---------------------------------------------------
    @property
    def num_rows(self) -> int:
        """Host row count — SYNCS if the count is still a device scalar."""
        if not isinstance(self._rows, int):
            from spark_rapids_tpu_torch.utils import checks as CK
            CK.note_host_sync("batch.num_rows", nbytes=4)
            self._rows = int(self._rows.item())
        return self._rows

    @num_rows.setter
    def num_rows(self, value):
        self._rows = value

    @property
    def num_rows_known(self) -> bool:
        return isinstance(self._rows, int)

    @property
    def num_rows_i32(self) -> torch.Tensor:
        """Row count as an int32 device scalar — never syncs."""
        if isinstance(self._rows, int):
            return torch.full((), self._rows, dtype=torch.int32,
                              device=self.device)
        return self._rows.to(torch.int32)

    def maybe_nonempty(self) -> bool:
        """True unless the batch is KNOWN to be empty (no sync)."""
        return not isinstance(self._rows, int) or self._rows > 0

    def verify_checks(self) -> None:
        from spark_rapids_tpu_torch.utils import checks as CK
        CK.verify(self.checks)

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else \
            bucket_capacity(self.num_rows)

    @property
    def device(self) -> torch.device:
        if self.columns:
            return self.columns[0].device
        if self.sparse is not None:
            return self.sparse.device
        if isinstance(self._rows, torch.Tensor):
            return self._rows.device
        return torch.device("cpu")

    def device_size_bytes(self) -> int:
        """Bytes the batch's tensors hold at capacity: data, validity,
        string lengths, 32-bit shadows and the selection mask."""
        total = 0 if self.sparse is None else self.sparse.numel()
        for c in self.columns:
            for t in (c.data, c.validity, c.narrow, c.lengths):
                if t is not None:
                    total += t.numel() * t.element_size()
        return total

    def column(self, name_or_idx) -> ColumnVector:
        if isinstance(name_or_idx, str):
            return self.columns[self.schema.index(name_or_idx)]
        return self.columns[name_or_idx]

    def row_mask(self) -> torch.Tensor:
        if self.sparse is not None:
            return self.sparse
        return torch.arange(self.capacity, device=self.device) \
            < self.num_rows_i32

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_numpy(data: dict, schema: Optional[T.Schema] = None,
                   validity: Optional[dict] = None,
                   capacity: Optional[int] = None,
                   device="cuda") -> "ColumnarBatch":
        dev = resolve_device(device)
        names = list(data)
        n = len(next(iter(data.values()))) if data else 0
        cap = capacity or bucket_capacity(n)
        cols, fields = [], []
        for name in names:
            dt = schema.field(name).dtype if schema else None
            v = validity.get(name) if validity else None
            c = ColumnVector.from_numpy(np.asarray(data[name]), dt, v, cap,
                                        device=dev)
            cols.append(c)
            fields.append(T.Field(name, c.dtype))
        _note_upload(cols, "batch.from_numpy", n)
        return ColumnarBatch(schema or T.Schema(tuple(fields)), cols, n)

    @staticmethod
    def from_arrow(table, device="cuda",
                   schema: Optional[T.Schema] = None) -> "ColumnarBatch":
        """Arrow table or record batch -> device batch (the scan's
        upload).  Values come from the Arrow buffers without Python
        objects: strings from their offsets and bytes (a dictionary
        column uploads its dictionary once and gathers it by the
        indices), null rows zero-filled.  With `schema`, each column
        takes the schema's type, which must share its storage (int32
        days as DATE32, as an engine frame holds them)."""
        dev = resolve_device(device)
        n = table.num_rows
        cap = bucket_capacity(n)
        cols, fields = [], []
        for i, (name, col) in enumerate(zip(table.schema.names,
                                            table.columns)):
            if hasattr(col, "combine_chunks"):
                col = col.combine_chunks()
            vec = _vector_from_arrow(col, cap, dev)
            if schema is not None and schema.fields[i].dtype != vec.dtype:
                want = schema.fields[i].dtype
                if want.is_string or vec.dtype.is_string or \
                        want.storage_dtype != vec.dtype.storage_dtype:
                    raise TypeError(f"column {name}: {vec.dtype} is not "
                                    f"stored as {want}")
                vec.dtype = want
            cols.append(vec)
            fields.append(T.Field(name, vec.dtype))
        _note_upload(cols, "batch.from_arrow", n)
        return ColumnarBatch(schema or T.Schema(tuple(fields)), cols, n)

    def _note_readback(self, site: str) -> None:
        """Ledger hook of the host-conversion sinks: the device
        footprint of the batch is what they pull to the host."""
        from spark_rapids_tpu_torch.utils import movement as MV
        if MV.ledger() is not None:
            MV.record(MV.EDGE_READBACK, self.device_size_bytes(),
                      site=site)

    def to_arrow(self):
        """Device batch -> pyarrow Table (what the writers encode).
        Strings go down as their live bytes and lengths and become a
        StringArray from those buffers."""
        import pyarrow as pa
        if self.sparse is not None:
            return self.dense().to_arrow()
        self._note_readback("collect.to_arrow")
        self.verify_checks()
        n = self.num_rows
        arrays = []
        for f, c in zip(self.schema.fields, self.columns):
            if f.dtype.is_string:
                offsets, chars, valid = strings_to_offsets(c, n)
                large = offsets[-1] >= 2**31
                cls = pa.LargeStringArray if large else pa.StringArray
                arrays.append(cls.from_buffers(
                    n, pa.py_buffer(offsets if large
                                    else offsets.astype(np.int32)),
                    pa.py_buffer(chars), _validity_buffer(valid),
                    int(n - valid.sum())))
                continue
            vals, valid = c.to_numpy(n)
            mask = None if valid.all() else ~valid
            if f.dtype.id == T.TypeId.TIMESTAMP_US:
                arrays.append(pa.array(vals, pa.int64(), mask=mask).cast(
                    T.to_arrow(f.dtype)))
            else:
                arrays.append(pa.array(vals, T.to_arrow(f.dtype),
                                       mask=mask))
        return pa.table(arrays, names=list(self.schema.names))

    # -- host conversion ----------------------------------------------------
    def to_pandas(self):
        import pandas as pd
        if self.sparse is not None:
            return self.dense().to_pandas()
        self._note_readback("collect.to_pandas")
        self.verify_checks()
        out = {}
        n = self.num_rows
        for f, c in zip(self.schema.fields, self.columns):
            vals, validity = c.to_numpy(n)
            if f.dtype.is_string:
                out[f.name] = pd.Series(list(vals), dtype=object)
            elif f.dtype.id == T.TypeId.TIMESTAMP_US:
                s = pd.Series(vals.astype("datetime64[us]"))
                s[~validity] = pd.NaT
                out[f.name] = s
            elif validity.all():
                out[f.name] = pd.Series(vals)
            else:
                s = pd.Series(vals).astype(object)
                s[~validity] = None
                out[f.name] = s
        return pd.DataFrame(out)

    # -- structural ---------------------------------------------------------
    def gather(self, indices: torch.Tensor, index_valid: torch.Tensor,
               new_num_rows) -> "ColumnarBatch":
        if self.sparse is not None:
            raise ValueError("gather() addresses dense rows")
        return ColumnarBatch(
            self.schema, [c.gather(indices, index_valid)
                          for c in self.columns], new_num_rows, self.checks)

    def select(self, names) -> "ColumnarBatch":
        """The named columns, in that order."""
        names = list(names)
        return ColumnarBatch(
            T.Schema(tuple(self.schema.field(n) for n in names)),
            [self.column(n) for n in names], self._rows, self.checks,
            self.sparse)

    def slice(self, start: int, length: int) -> "ColumnarBatch":
        """Rows [start, start + length) as a tightly bucketed batch."""
        if self.sparse is not None:
            return self.dense().slice(start, length)
        length = max(0, min(length, self.num_rows - start))
        cap = bucket_capacity(length)
        i = torch.arange(cap, device=self.device)
        valid = i < length
        return self.gather(torch.where(valid, i + start, 0), valid, length)

    def take_head(self, n: int) -> "ColumnarBatch":
        """The first min(n, num_rows) rows at capacity bucket(n), without
        reading a lazy row count back."""
        if self.sparse is not None:
            return self.dense().take_head(n)
        cap = bucket_capacity(n)
        if cap >= self.capacity:
            rows = (min(self._rows, n) if self.num_rows_known
                    else torch.clamp(self.num_rows_i32, max=n))
            return ColumnarBatch(self.schema, self.columns, rows,
                                 self.checks)
        count = torch.clamp(self.num_rows_i32, max=n)
        i = torch.arange(cap, device=self.device)
        rows = min(self._rows, n) if self.num_rows_known else count
        return self.gather(i, i < count, rows)

    def with_capacity(self, capacity: int) -> "ColumnarBatch":
        if capacity == self.capacity:
            return self
        if self.sparse is not None:
            return self.dense().with_capacity(capacity)
        rows = (min(self._rows, capacity) if self.num_rows_known
                else torch.clamp(self._rows, max=capacity))
        return ColumnarBatch(
            self.schema, [c.with_capacity(capacity) for c in self.columns],
            rows, self.checks)


def _note_upload(cols: list, site: str, rows: int) -> None:
    """Ledger hook of the host->device construction points: one upload
    record per batch, the device footprint of its columns."""
    from spark_rapids_tpu_torch.utils import movement as MV
    if cols and MV.ledger() is not None:
        MV.record(MV.EDGE_UPLOAD,
                  sum(MV.vector_device_bytes(c) for c in cols),
                  site=site, rows=rows)


def _validity_buffer(valid: np.ndarray):
    """Arrow's validity bitmap of a bool mask (None when all valid)."""
    import pyarrow as pa
    if valid.all():
        return None
    return pa.py_buffer(np.packbits(valid, bitorder="little"))


def _vector_from_arrow(col, cap: int, dev) -> ColumnVector:
    """One Arrow array as a device column of capacity `cap`."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = len(col)
    valid = (np.ones(n, bool) if col.null_count == 0
             else ~col.is_null().to_numpy(zero_copy_only=False))
    if pa.types.is_dictionary(col.type):
        # encode the dictionary once, gather its rows by the indices
        dvec = _vector_from_arrow(col.dictionary,
                                  bucket_capacity(len(col.dictionary)), dev)
        idx = _upload(pc.fill_null(col.indices, 0).to_numpy(
            zero_copy_only=False).astype(np.int64), cap, dev)
        out = dvec.gather(idx, _upload(valid, cap, dev))
        if dvec.dtype.is_string:
            out.lengths = torch.where(out.validity, out.lengths, 0)
        return out
    dt = T.from_arrow(col.type)
    if dt.is_string:
        bufs = col.buffers()
        odt = np.int64 if pa.types.is_large_string(col.type) else np.int32
        offsets = np.frombuffer(bufs[1], odt)[col.offset:col.offset + n + 1]
        chars = (np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None
                 else np.zeros(0, np.uint8))
        return strings_from_offsets(offsets, chars, valid, cap, dev)
    if dt.id == T.TypeId.DATE32:
        col = col.cast(pa.int32())
    elif dt.id == T.TypeId.TIMESTAMP_US:
        col = col.cast(pa.timestamp("us", tz=col.type.tz)).cast(pa.int64())
    if col.null_count:
        col = pc.fill_null(col, False if dt.id == T.TypeId.BOOL else 0)
    vals = col.to_numpy(zero_copy_only=False).astype(dt.storage_dtype,
                                                      copy=False)
    return ColumnVector.from_numpy(vals, dt, valid, cap, device=dev)


def empty_batch(schema: T.Schema, device) -> ColumnarBatch:
    """Zero-row batch with properly-typed zero-filled columns."""
    cols = []
    for f in schema.fields:
        validity = torch.zeros(MIN_CAPACITY, dtype=torch.bool,
                               device=device)
        if f.dtype.is_string:
            cols.append(ColumnVector(
                f.dtype, torch.zeros((MIN_CAPACITY, MIN_CHAR_CAP),
                                     dtype=torch.uint8, device=device),
                validity, lengths=torch.zeros(
                    MIN_CAPACITY, dtype=torch.int32, device=device)))
        else:
            cols.append(ColumnVector(
                f.dtype, torch.zeros(MIN_CAPACITY,
                                     dtype=f.dtype.torch_dtype,
                                     device=device), validity))
    return ColumnarBatch(schema, cols, 0)


def _fills(values, dev) -> torch.Tensor:
    """int64 vector of host ints built by fill kernels (a host-to-device
    copy would wait for the stream)."""
    return torch.cat([torch.full((1,), int(v), dtype=torch.int64,
                                 device=dev) for v in values])


def concat_batches(batches: list[ColumnarBatch],
                   sparse_ok: bool = False) -> ColumnarBatch:
    """Device-side concat: stack padded columns, then gather the live rows
    of each input into a fresh bucketed batch.  When any input's row count
    is still a device scalar, the gather indices are computed on the
    device (no sync) and the output capacity is the bucketed sum of input
    capacities.  `sparse_ok=True` (consumers that take sparse batches)
    stacks sparse inputs as they are and keeps the result sparse."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len(batches) == 1:
        return batches[0]
    if sparse_ok and any(b.sparse is not None for b in batches):
        return _concat_sparse(batches)
    batches = [b.dense() for b in batches]
    schema = batches[0].schema
    dev = batches[0].device
    checks = tuple(c for b in batches for c in b.checks)
    caps = [b.capacity for b in batches]
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]])
    stacked = _stack_columns(batches, schema)
    if all(b.num_rows_known for b in batches):
        total = sum(b.num_rows for b in batches)
        cap = bucket_capacity(total)
        parts = [torch.arange(b.num_rows, device=dev) + int(off)
                 for b, off in zip(batches, offsets)]
        idx = torch.cat(parts + [torch.zeros(cap - total, dtype=torch.int64,
                                             device=dev)])
        rows = total
    else:
        ns = torch.stack([b.num_rows_i32 for b in batches]).to(torch.int64)
        cum = torch.cumsum(ns, 0)
        starts = cum - ns
        cap = bucket_capacity(int(sum(caps)))
        i = torch.arange(cap, device=dev)
        bid = torch.searchsorted(cum, i, right=True).clamp(
            max=len(batches) - 1)
        idx = _fills(offsets, dev)[bid] + (i - starts[bid])
        rows = cum[-1].to(torch.int32)
        idx = torch.where(i < rows, idx, 0)
    valid = torch.arange(cap, device=dev) < rows
    return ColumnarBatch(schema, [c.gather(idx, valid) for c in stacked],
                         rows, checks)


def _stack_columns(batches, schema) -> list[ColumnVector]:
    """Each column of `batches` stacked end to end (string columns
    padded to their widest char capacity first)."""
    out = []
    for ci, f in enumerate(schema.fields):
        vecs = [b.columns[ci] for b in batches]
        if f.dtype.is_string:
            cc = max(v.char_cap for v in vecs)
            vecs = [_pad_chars(v, cc) for v in vecs]
        narrow = (torch.cat([v.narrow for v in vecs])
                  if all(v.narrow is not None for v in vecs) else None)
        lengths = (torch.cat([v.lengths for v in vecs])
                   if f.dtype.is_string else None)
        out.append(ColumnVector(f.dtype, torch.cat([v.data for v in vecs]),
                                torch.cat([v.validity for v in vecs]),
                                narrow, lengths))
    return out


def _concat_sparse(batches) -> ColumnarBatch:
    """Gather-free concat: stack each input's padded columns and its
    selection mask; the result stays sparse."""
    schema = batches[0].schema
    dev = batches[0].device
    checks = tuple(c for b in batches for c in b.checks)
    scap = sum(b.capacity for b in batches)
    cap = bucket_capacity(scap)
    pad = cap - scap
    masks = [b.sparse if b.sparse is not None else b.row_mask()
             for b in batches]
    if pad:
        masks.append(torch.zeros(pad, dtype=torch.bool, device=dev))
    mask = torch.cat(masks)
    if all(b.num_rows_known for b in batches):
        total = sum(b.num_rows for b in batches)
    else:
        total = torch.stack([b.num_rows_i32 for b in batches]).sum().to(
            torch.int32)

    cols = [c.with_capacity(cap) for c in _stack_columns(batches, schema)]
    return ColumnarBatch(schema, cols, total, checks, sparse=mask)
