"""Shuffle payload compression codecs (port of
spark_rapids_tpu/shuffle/compression.py; reference
`TableCompressionCodec.scala:42-120`, `CopyCompressionCodec.scala`).

The codecs compress the serialized host payload of a batch on the wire:
a device batch is typed tensors, not one byte buffer, so compression
applies where the bytes exist.  The codec id and the uncompressed size
travel in every DATA frame (the reference's CodecBufferDescriptor role),
and the receiver inflates before the blob lands in the host store.  lz4
and zstd are pyarrow's host codecs, imported when a codec is first made;
`copy` is the reference's pass-through testing codec.  The wire ids are
the JAX package's, so a frame compressed by either inflates in the other.
"""
from __future__ import annotations

import threading
from typing import Optional

# codec ids on the wire (reference format/CodecType.java: COPY = 0)
CODEC_NONE = -1   # never on the wire; "no compression" sentinel
CODEC_COPY = 0
CODEC_LZ4 = 1
CODEC_ZSTD = 2


class TableCompressionCodec:
    """SPI: compress/decompress one serialized table payload."""

    #: short name used in conf and logging
    name: str = "?"
    #: wire id (CodecType analog)
    codec_id: int = CODEC_NONE

    def compress(self, blob: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, blob: bytes, uncompressed_size: int) -> bytes:
        raise NotImplementedError


class CopyCompressionCodec(TableCompressionCodec):
    """Pass-through codec for protocol testing (reference
    `CopyCompressionCodec.scala`: a device memcpy)."""

    name = "copy"
    codec_id = CODEC_COPY

    def compress(self, blob: bytes) -> bytes:
        return bytes(blob)

    def decompress(self, blob: bytes, uncompressed_size: int) -> bytes:
        if len(blob) != uncompressed_size:
            raise ValueError(
                f"copy codec size mismatch: {len(blob)} != "
                f"{uncompressed_size}")
        return bytes(blob)


class _ArrowCodec(TableCompressionCodec):
    """Host codec backed by pyarrow's buffer compression."""

    _arrow_name: str = "?"

    def __init__(self):
        import pyarrow as pa
        self._codec = pa.Codec(self._arrow_name)

    def compress(self, blob: bytes) -> bytes:
        return self._codec.compress(blob, asbytes=True)

    def decompress(self, blob: bytes, uncompressed_size: int) -> bytes:
        return self._codec.decompress(
            blob, decompressed_size=uncompressed_size, asbytes=True)


class Lz4CompressionCodec(_ArrowCodec):
    name = "lz4"
    codec_id = CODEC_LZ4
    _arrow_name = "lz4"


class ZstdCompressionCodec(_ArrowCodec):
    name = "zstd"
    codec_id = CODEC_ZSTD
    _arrow_name = "zstd"


_BY_NAME = {c.name: c for c in
            (CopyCompressionCodec, Lz4CompressionCodec,
             ZstdCompressionCodec)}
# names an earlier conf doc of the reference advertised
_BY_NAME["lz4-host"] = Lz4CompressionCodec
_BY_NAME["zstd-host"] = ZstdCompressionCodec
_BY_ID = {c.codec_id: c for c in _BY_NAME.values()}
_CACHE: dict[int, TableCompressionCodec] = {}
_CACHE_LOCK = threading.Lock()


def get_codec(name_or_id) -> Optional[TableCompressionCodec]:
    """Codec lookup with an instance cache (reference
    `TableCompressionCodec.getCodec`): the conf short name or the wire
    id; "none"/CODEC_NONE -> None (no compression)."""
    if name_or_id in (None, "none", CODEC_NONE):
        return None
    if isinstance(name_or_id, str):
        cls = _BY_NAME.get(name_or_id)
        if cls is None:
            raise ValueError(f"Unknown table codec: {name_or_id}")
    else:
        cls = _BY_ID.get(int(name_or_id))
        if cls is None:
            raise ValueError(f"Unknown codec ID: {name_or_id}")
    with _CACHE_LOCK:
        inst = _CACHE.get(cls.codec_id)
        if inst is None:
            inst = _CACHE[cls.codec_id] = cls()
        return inst


def codec_from_conf(conf) -> Optional[TableCompressionCodec]:
    from spark_rapids_tpu_torch import config as C
    return get_codec(str(conf[C.SHUFFLE_COMPRESSION_CODEC]).lower())


# ---------------------------------------------------------------------------
# per-codec wire accounting (always on, like the host-sync counter): every
# compressed payload the shuffle server serves notes its raw and wire
# sizes here, so codec choice shows as a measured ratio beside the
# movement report's wire edge
_STATS_LOCK = threading.Lock()
_STATS: dict[str, list] = {}  # codec name -> [raw_bytes, wire_bytes, n]


def note_compression(codec_name: str, raw_bytes: int,
                     wire_bytes: int) -> None:
    """Record one payload's compression outcome for `codec_name`."""
    with _STATS_LOCK:
        st = _STATS.setdefault(codec_name, [0, 0, 0])
        st[0] += int(raw_bytes)
        st[1] += int(wire_bytes)
        st[2] += 1


def compression_stats() -> dict:
    """{codec: {raw_bytes, wire_bytes, payloads, ratio}} copy; ratio is
    wire/raw (< 1.0 means the codec is earning its CPU)."""
    with _STATS_LOCK:
        return {name: {"raw_bytes": r, "wire_bytes": w, "payloads": n,
                       "ratio": round(w / r, 4) if r else 1.0}
                for name, (r, w, n) in _STATS.items()}


def reset_compression_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()
