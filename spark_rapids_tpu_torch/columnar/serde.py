"""Contiguous host serialization of ColumnarBatch (port of
spark_rapids_tpu/columnar/serde.py, byte for byte the same format).

One contiguous byte payload per batch plus a small metadata header, so a
batch can spill device->host->disk as a single blob (and, later, travel
the shuffle wire).  Rows are trimmed to `num_rows` ON THE DEVICE before
they are copied to the host, and re-padded to the capacity bucket on the
device on deserialize: padding never crosses PCIe, the wire or the disk.

Layout: MAGIC | header_len:u32 | header(json utf8) | col payloads…
Header: {num_rows, fields: [{name, dtype, size, char_cap?}]}.
Each column payload = data bytes (row-trimmed; strings also trimmed to
the longest string) + int32 string lengths + validity (packed bits).

Two header keys of the port's own, which the reference's reader ignores:
"narrow" marks a column that carried a 32-bit shadow (an int32 copy of
an int64 column, an f32 copy of a float64 one), rebuilt from the data on
read so a re-read batch takes the same lanes; "nullable" is written only
when false, so the schema comes back as it was.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    _f32_shadow, _upload,
                                                    bucket_capacity,
                                                    bucket_char_cap,
                                                    resolve_device)

MAGIC = b"TPUB"


def _pack_bits(mask: np.ndarray) -> bytes:
    return np.packbits(mask.astype(np.uint8), bitorder="little").tobytes()


def _unpack_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8),
                         bitorder="little")[:n].astype(bool)


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy())


def serialize_batch(batch: ColumnarBatch) -> bytes:
    """Reads the row count and the longest string back (one sync each on
    the spill path, which the reference accepts too)."""
    batch = batch.dense()
    batch.verify_checks()
    n = batch.num_rows
    fields_meta = []
    payloads = []
    for f, c in zip(batch.schema.fields, batch.columns):
        meta = {"name": f.name, "dtype": f.dtype.id.value}
        validity = _host(c.validity[:n])
        if f.dtype.is_string:
            lens = _host(c.lengths[:n]).astype(np.int32)
            used = int(lens.max()) if n else 0
            data = _host(c.data[:n, :used])
            meta["char_cap"] = used
            payload = (data.tobytes() + lens.tobytes()
                       + _pack_bits(validity))
        else:
            payload = _host(c.data[:n]).tobytes() + _pack_bits(validity)
            if c.narrow is not None:
                meta["narrow"] = 1
        if not f.nullable:
            meta["nullable"] = False
        meta["size"] = len(payload)
        fields_meta.append(meta)
        payloads.append(payload)
    header = json.dumps({"num_rows": n, "fields": fields_meta},
                        separators=(",", ":")).encode()
    out = bytearray()
    out += MAGIC
    out += len(header).to_bytes(4, "little")
    out += header
    for p in payloads:
        out += p
    return bytes(out)


def peek_meta(blob: bytes) -> dict:
    """Read just the header (the TableMeta analog) without materializing."""
    if blob[:4] != MAGIC:
        raise ValueError("bad magic")
    hlen = int.from_bytes(blob[4:8], "little")
    return json.loads(blob[8:8 + hlen].decode())


def _shadow(dt: T.DataType, data: torch.Tensor) -> Optional[torch.Tensor]:
    if dt.id in (T.TypeId.INT64, T.TypeId.TIMESTAMP_US):
        return data.to(torch.int32)
    if dt.id == T.TypeId.FLOAT64:
        return _f32_shadow(data)
    return None


def deserialize_batch(blob: bytes, device,
                      capacity: Optional[int] = None) -> ColumnarBatch:
    """The batch of `blob` on `device` ("cuda" raises without a card),
    padded to `capacity` (default: the row count's bucket)."""
    dev = resolve_device(device)
    meta = peek_meta(blob)
    hlen = int.from_bytes(blob[4:8], "little")
    off = 8 + hlen
    n = meta["num_rows"]
    cap = capacity or bucket_capacity(n)
    cols, fields = [], []
    for fm in meta["fields"]:
        dt = T.DataType(T.TypeId(fm["dtype"]))
        payload = blob[off:off + fm["size"]]
        off += fm["size"]
        if dt.is_string:
            used = fm["char_cap"]
            dsz = n * used
            raw = np.frombuffer(payload[:dsz], np.uint8).reshape(n, used)
            lens = np.frombuffer(payload[dsz:dsz + 4 * n], np.int32)
            validity = _unpack_bits(payload[dsz + 4 * n:], n)
            data = torch.zeros((cap, bucket_char_cap(used)),
                               dtype=torch.uint8, device=dev)
            data[:n, :used].copy_(torch.from_numpy(raw.copy()))
            col = ColumnVector(dt, data, _upload(validity, cap, dev),
                               lengths=_upload(lens.copy(), cap, dev))
        else:
            storage = dt.storage_dtype
            dsz = n * storage.itemsize
            vals = np.frombuffer(payload[:dsz], storage).copy()
            validity = _unpack_bits(payload[dsz:], n)
            data = _upload(vals, cap, dev)
            col = ColumnVector(dt, data, _upload(validity, cap, dev),
                               _shadow(dt, data) if fm.get("narrow")
                               else None)
        cols.append(col)
        fields.append(T.Field(fm["name"], dt, fm.get("nullable", True)))
    return ColumnarBatch(T.Schema(tuple(fields)), cols, n)
