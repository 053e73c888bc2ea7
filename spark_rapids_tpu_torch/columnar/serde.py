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

Each direction crosses between device and host in ONE copy per batch
(a shuffle moves thousands of small slices a query, and a copy per
array cost a sync each): the serializer gathers every column's live
rows, lengths and validity on the device and copies them down at once;
the deserializer lays the padded columns out on the host and copies
them up at once, each column a view of that copy.

Two header keys of the port's own, which the reference's reader ignores:
"narrow" marks a column that carried a 32-bit shadow (an int32 copy of
an int64 column, an f32 copy of a float64 one), rebuilt from the data on
read so a re-read batch takes the same lanes; "nullable" is written only
when false, so the schema comes back as it was.
"""
from __future__ import annotations

import functools
import json
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    _f32_shadow,
                                                    bucket_capacity,
                                                    bucket_char_cap,
                                                    resolve_device)

MAGIC = b"TPUB"


def _pack_bits(mask: np.ndarray) -> bytes:
    return np.packbits(mask.view(np.uint8), bitorder="little").tobytes()


def _unpack_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8), count=n,
                         bitorder="little").view(np.bool_)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, as a flat uint8 tensor (a view)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def serialize_batch(batch: ColumnarBatch) -> bytes:
    """Reads the row count back (one sync when it is lazy), then every
    column's live rows, string lengths and validity in ONE device-to-host
    copy; the strings are cut to their longest one and the validity
    packed on the host."""
    batch = batch.dense()
    # movement ledger: serialization pulls the batch host-side (spill /
    # shuffle-serve readback); the bytes are its device footprint, as
    # the reference counts them
    from spark_rapids_tpu_torch.utils import movement as MV
    if MV.ledger() is not None:
        MV.record(MV.EDGE_READBACK, batch.device_size_bytes(),
                  site="serde.serialize")
    batch.verify_checks()
    n = batch.num_rows
    pieces = []
    for f, c in zip(batch.schema.fields, batch.columns):
        pieces.append(_as_bytes(c.data[:n]))
        if f.dtype.is_string:
            pieces.append(_as_bytes(c.lengths[:n].to(torch.int32)))
        pieces.append(_as_bytes(c.validity[:n]))
    host = (torch.cat(pieces).cpu().numpy() if pieces
            else np.zeros(0, np.uint8))
    off = 0

    def take(nbytes: int) -> np.ndarray:
        nonlocal off
        out = host[off:off + nbytes]
        off += nbytes
        return out

    fields_meta = []
    payloads = []
    for f, c in zip(batch.schema.fields, batch.columns):
        meta = {"name": f.name, "dtype": f.dtype.id.value}
        if f.dtype.is_string:
            cc = c.data.shape[1]
            chars = take(n * cc).reshape(n, cc)
            lens = take(4 * n).view(np.int32)
            used = int(lens.max()) if n else 0
            payload = (np.ascontiguousarray(chars[:, :used]).tobytes()
                       + lens.tobytes() + _pack_bits(take(n)))
            meta["char_cap"] = used
        else:
            payload = (take(n * c.data.element_size()).tobytes()
                       + _pack_bits(take(n)))
            if c.narrow is not None:
                meta["narrow"] = 1
        if not f.nullable:
            meta["nullable"] = False
        meta["size"] = len(payload)
        fields_meta.append(meta)
        payloads.append(payload)
    header = json.dumps({"num_rows": n, "fields": fields_meta},
                        separators=(",", ":")).encode()
    return b"".join([MAGIC, len(header).to_bytes(4, "little"), header]
                    + payloads)


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


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def deserialize_batch(blob: bytes, device,
                      capacity: Optional[int] = None) -> ColumnarBatch:
    """The batch of `blob` on `device` ("cuda" raises without a card),
    padded to `capacity` (default: the row count's bucket).  Every column
    is laid out padded on the host, and all of them go to the device in
    ONE copy; each column's tensors are views of that copy."""
    dev = resolve_device(device)
    meta = peek_meta(blob)
    off = 8 + int.from_bytes(blob[4:8], "little")
    n = meta["num_rows"]
    cap = capacity or bucket_capacity(n)
    arrays = []  # per column: [(data, validity, lengths-or-None)] on host
    for fm in meta["fields"]:
        dt = T.DataType(T.TypeId(fm["dtype"]))
        payload = blob[off:off + fm["size"]]
        off += fm["size"]
        validity = np.zeros(cap, np.bool_)
        if dt.is_string:
            used = fm["char_cap"]
            dsz = n * used
            data = np.zeros((cap, bucket_char_cap(used)), np.uint8)
            data[:n, :used] = np.frombuffer(payload[:dsz],
                                            np.uint8).reshape(n, used)
            lens = np.zeros(cap, np.int32)
            lens[:n] = np.frombuffer(payload[dsz:dsz + 4 * n], np.int32)
            validity[:n] = _unpack_bits(payload[dsz + 4 * n:], n)
            arrays.append((data, validity, lens))
        else:
            dsz = n * dt.storage_dtype.itemsize
            data = np.zeros(cap, dt.storage_dtype)
            data[:n] = np.frombuffer(payload[:dsz], dt.storage_dtype)
            validity[:n] = _unpack_bits(payload[dsz:], n)
            arrays.append((data, validity, None))
    # one host buffer, each array at an 8-byte aligned offset, so every
    # typed view of the device copy is aligned
    flat = [a for group in arrays for a in group if a is not None]
    offsets, total = [], 0
    for a in flat:
        offsets.append(total)
        total += -(-a.nbytes // 8) * 8
    host = np.empty(total, np.uint8)
    for a, o in zip(flat, offsets):
        host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = torch.from_numpy(host).to(dev)
    views = iter(buf[o:o + a.nbytes].view(_torch_dtype(a.dtype)).view(
        a.shape) for a, o in zip(flat, offsets))
    cols, fields = [], []
    for fm, (_, _, lens) in zip(meta["fields"], arrays):
        dt = T.DataType(T.TypeId(fm["dtype"]))
        data, validity = next(views), next(views)
        if lens is not None:
            col = ColumnVector(dt, data, validity, lengths=next(views))
        else:
            col = ColumnVector(dt, data, validity,
                               _shadow(dt, data) if fm.get("narrow")
                               else None)
        cols.append(col)
        fields.append(T.Field(fm["name"], dt, fm.get("nullable", True)))
    out = ColumnarBatch(T.Schema(tuple(fields)), cols, n)
    # movement ledger: deserialization re-uploads the padded arrays
    # (spill re-read / shuffle-receive materialization)
    from spark_rapids_tpu_torch.utils import movement as MV
    if MV.ledger() is not None:
        MV.record(MV.EDGE_UPLOAD, out.device_size_bytes(),
                  site="serde.deserialize")
    return out
