"""Shuffle transport SPI and control protocol (port of
spark_rapids_tpu/shuffle/transport.py; reference
`RapidsShuffleTransport.scala:38-659`: the pluggable transport trait with
`makeClient`/`makeServer`, bounce-buffer pools, the in-flight byte
throttle and the `Transaction` lifecycle, and the FlatBuffers control
messages `ShuffleMetadataRequest/Response.fbs`, `ShuffleTransferRequest.fbs`).

A reduce task pulls in two phases, metadata then data, and the data
arrives as serialized batches in bounce-buffer-sized DATA frames.  The
frames are byte for byte the JAX package's, so either package decodes
what the other encodes:

  control frame: u32 len | u8 kind | json payload
  data frame:    u32 len | u8 DATA | u64 table_id | u32 seq | u8 codec+1
                 | u64 raw_len | u32 crc32 | bytes

`make_transport` loads the implementation by the class name in
spark.rapids.shuffle.transport.class, as the reference does.  A class of
the JAX package is refused, not imported: the port never imports it.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import json
import struct
import threading
import zlib
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.memory.buffer import BufferId, TableMeta


class MsgKind(enum.IntEnum):
    METADATA_REQUEST = 1
    METADATA_RESPONSE = 2
    TRANSFER_REQUEST = 3
    TRANSFER_RESPONSE = 4
    DATA = 5


@dataclasses.dataclass(frozen=True)
class BlockIdMsg:
    """One shuffle block coordinate (shuffle_id, map_id, partition)."""
    shuffle_id: int
    map_id: int
    partition: int


@dataclasses.dataclass(frozen=True)
class TableMetaMsg:
    """Wire TableMeta (reference ShuffleCommon.fbs TableMeta)."""
    table_id: int
    shuffle_id: int
    map_id: int
    partition: int
    num_rows: int
    size_bytes: int
    schema_fields: tuple  # ((name, dtype_value, nullable), ...)

    @staticmethod
    def of(bid: BufferId, meta: TableMeta) -> "TableMetaMsg":
        return TableMetaMsg(
            bid.table_id, bid.shuffle_id, bid.map_id, bid.partition,
            meta.num_rows, meta.size_bytes,
            tuple((f.name, f.dtype.id.value, f.nullable)
                  for f in meta.schema.fields))

    def table_meta(self) -> TableMeta:
        schema = T.Schema(tuple(
            T.Field(n, T.DataType(T.TypeId(d)), nl)
            for n, d, nl in self.schema_fields))
        return TableMeta(schema, self.num_rows, self.size_bytes)

    @property
    def is_degenerate(self) -> bool:
        return self.size_bytes == 0


# -- frame encode/decode ------------------------------------------------------
def encode_control(kind: MsgKind, payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode()
    return struct.pack("<IB", len(body) + 1, int(kind)) + body


class WireCorruption(Exception):
    """A DATA frame failed its payload CRC: the chunk was damaged in
    flight; the transaction fails and the bounded retry re-requests it."""


def encode_data(table_id: int, seq: int, chunk: bytes,
                codec_id: int = -1, raw_len: int = 0) -> bytes:
    """DATA frame; codec_id/raw_len play the reference's
    CodecBufferDescriptor role (ShuffleCommon.fbs): -1 = uncompressed,
    else the payload is `codec_id`-compressed and inflates to raw_len.
    A crc32 of the payload rides in the header so wire damage is caught
    at the receiver."""
    return struct.pack("<IBQIBQI", len(chunk) + 26, int(MsgKind.DATA),
                       table_id, seq, codec_id + 1, raw_len,
                       zlib.crc32(chunk) & 0xFFFFFFFF) + chunk


def decode_frame(frame: bytes) -> tuple[MsgKind, object]:
    """One frame without its length prefix -> (kind, payload)."""
    kind = MsgKind(frame[0])
    if kind == MsgKind.DATA:
        table_id, seq, codec_byte, raw_len, crc = struct.unpack_from(
            "<QIBQI", frame, 1)
        chunk = frame[26:]
        if zlib.crc32(chunk) & 0xFFFFFFFF != crc:
            raise WireCorruption(
                f"DATA frame for table {table_id} seq {seq >> 1} failed "
                f"crc32")
        return kind, (table_id, seq, chunk, codec_byte - 1, raw_len)
    return kind, json.loads(frame[1:].decode())


def meta_request(blocks: Sequence[BlockIdMsg]) -> bytes:
    return encode_control(MsgKind.METADATA_REQUEST, {
        "blocks": [[b.shuffle_id, b.map_id, b.partition] for b in blocks]})


def meta_response(metas: Sequence[TableMetaMsg]) -> bytes:
    return encode_control(MsgKind.METADATA_RESPONSE, {
        "tables": [[m.table_id, m.shuffle_id, m.map_id, m.partition,
                    m.num_rows, m.size_bytes,
                    list(map(list, m.schema_fields))] for m in metas]})


def parse_meta_response(payload: dict) -> list[TableMetaMsg]:
    return [TableMetaMsg(t[0], t[1], t[2], t[3], t[4], t[5],
                         tuple(tuple(f) for f in t[6]))
            for t in payload["tables"]]


def transfer_request(table_ids: Sequence[int]) -> bytes:
    return encode_control(MsgKind.TRANSFER_REQUEST,
                          {"table_ids": list(table_ids)})


# ---------------------------------------------------------------------------
class BounceBufferManager:
    """Fixed pool of staging buffers (reference
    BounceBufferManager.scala:55-128: one registered buffer sliced into N
    fixed bounce buffers with a blocking acquire)."""

    def __init__(self, buffer_size: int, count: int):
        self.buffer_size = buffer_size
        self._free = [bytearray(buffer_size) for _ in range(count)]
        self._cv = threading.Condition()

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> Optional[bytearray]:
        with self._cv:
            while not self._free:
                if not blocking:
                    return None
                if not self._cv.wait(timeout):
                    return None
            return self._free.pop()

    def release(self, buf: bytearray) -> None:
        with self._cv:
            self._free.append(buf)
            self._cv.notify()

    @property
    def free_count(self) -> int:
        with self._cv:
            return len(self._free)


class InflightLimiter:
    """Byte budget for outstanding receives (reference
    maxReceiveInflightBytes, RapidsShuffleClient.scala:108).  A request
    larger than the budget is clamped to it instead of deadlocking."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._used = 0
        self._cv = threading.Condition()

    def acquire(self, nbytes: int, timeout: Optional[float] = None) -> bool:
        nbytes = min(nbytes, self.max_bytes)
        with self._cv:
            while self._used + nbytes > self.max_bytes:
                if not self._cv.wait(timeout):
                    return False
            self._used += nbytes
            return True

    def release(self, nbytes: int) -> None:
        nbytes = min(nbytes, self.max_bytes)
        with self._cv:
            self._used -= nbytes
            self._cv.notify_all()


# ---------------------------------------------------------------------------
class TransactionStatus(enum.Enum):
    SUCCESS = "success"
    ERROR = "error"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class Transaction:
    """Completed-exchange record (reference Transaction trait :311-380).
    `corrupt` marks a failure caused by a DATA-frame CRC mismatch, so the
    client counts detected wire damage apart from plain connection
    loss."""
    status: TransactionStatus
    error: Optional[str] = None
    bytes_transferred: int = 0
    corrupt: bool = False


class Connection:
    """Client-side connection to one peer executor.

    `request` performs a control round trip; `fetch` streams the DATA
    frames of the requested tables to `on_chunk(table_id, seq, bytes,
    is_last, codec_id, raw_len)` (codec_id -1 = uncompressed)."""

    def request(self, frame: bytes) -> tuple[MsgKind, object]:
        raise NotImplementedError

    def fetch(self, table_ids: Sequence[int],
              on_chunk: Callable[..., None]) -> Transaction:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ShuffleTransport:
    """Transport SPI (reference RapidsShuffleTransport trait)."""

    def __init__(self, conf: C.RapidsConf):
        self.conf = conf
        self.receive_limiter = InflightLimiter(
            conf[C.SHUFFLE_MAX_RECV_INFLIGHT])
        self.send_bounce = BounceBufferManager(
            conf[C.SHUFFLE_BOUNCE_BUFFER_SIZE],
            conf[C.SHUFFLE_BOUNCE_BUFFER_COUNT])

    def make_server(self, executor_id: str, request_handler) -> "object":
        """Start serving this executor's shuffle data.  `request_handler`
        exposes handle_metadata_request(blocks) -> [TableMetaMsg] and
        send_state(table_ids, emit, wire)."""
        raise NotImplementedError

    def can_reach(self, address: str) -> bool:
        """Whether this process can open `address` (loopback addresses
        are per process)."""
        return True

    def make_client(self, peer_address: str) -> Connection:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


#: the JAX package's top-level name: a transport class under it is refused
_REFERENCE_PACKAGE = "spark_rapids_tpu"


def make_transport(conf: Optional[C.RapidsConf] = None) -> ShuffleTransport:
    """Load the transport by its conf class name (reference
    RapidsShuffleTransport.makeTransport, RapidsConf.scala:592).  One conf
    may drive both packages, and the JAX package's default names its own
    class: that name is refused with the port's, never imported."""
    conf = conf or C.get_active_conf()
    path = str(conf[C.SHUFFLE_TRANSPORT_CLASS])
    mod_name, cls_name = path.rsplit(".", 1)
    if mod_name.split(".")[0] == _REFERENCE_PACKAGE:
        raise ValueError(
            f"{C.SHUFFLE_TRANSPORT_CLASS.key}={path} names a class of the "
            f"JAX package, which this package does not import; use "
            f"{C.SHUFFLE_TRANSPORT_CLASS.default}")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    return cls(conf)
