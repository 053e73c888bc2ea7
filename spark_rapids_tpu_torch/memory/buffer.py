"""Spillable buffer abstraction (port of spark_rapids_tpu/memory/buffer.py;
reference `RapidsBuffer.scala`,
`RapidsBufferId`, `MetaUtils.buildDegenerateTableMeta`).

A `SpillableBuffer` is one batch's worth of data pinned at a storage tier
with a refcount: while acquired it cannot spill; released (refcount 0) it
becomes a spill candidate ordered by `spill_priority`.  `TableMeta` is the
host-side descriptor that survives even when the data moves tiers (or, for
degenerate rows-but-no-columns batches, when there is no data at all).
"""
from __future__ import annotations

import dataclasses
import enum
import threading

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class StorageTier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


@dataclasses.dataclass(frozen=True)
class TableMeta:
    """Descriptor of a stored batch (FlatBuffers TableMeta analog)."""
    schema: T.Schema
    num_rows: int
    size_bytes: int

    @property
    def is_degenerate(self) -> bool:
        return self.size_bytes == 0


@dataclasses.dataclass(frozen=True)
class BufferId:
    """Identifies a buffer across tiers.  Shuffle buffer ids also carry the
    (shuffle_id, map_id, partition) coordinates (ShuffleBufferId analog)."""
    table_id: int
    shuffle_id: int = -1
    map_id: int = -1
    partition: int = -1


class SpillableBuffer:
    """Base buffer: subclasses hold the payload for one tier."""

    tier: StorageTier

    def __init__(self, bid: BufferId, meta: TableMeta, spill_priority: float):
        self.id = bid
        self.meta = meta
        self.spill_priority = spill_priority
        self._refcount = 0
        self._lock = threading.Lock()
        self._closed = False
        self._spilling = False
        self.store = None  # owning BufferStore, set on add

    # -- refcounting (acquire pins against spilling) ------------------------
    def add_reference(self) -> None:
        with self._lock:
            if self._closed or self._spilling:
                raise ValueError(f"buffer {self.id} freed or spilling")
            self._refcount += 1

    def try_mark_spilling(self) -> bool:
        """Atomically claim the buffer for spilling; fails if a reader
        pinned it since the spill-queue check.  Once claimed, acquisition
        attempts fail until the catalog resolves the next-tier copy."""
        with self._lock:
            if self._refcount > 0 or self._closed or self._spilling:
                return False
            self._spilling = True
            return True

    def close(self) -> None:
        with self._lock:
            assert self._refcount > 0, "close without acquire"
            self._refcount -= 1

    @property
    def refcount(self) -> int:
        with self._lock:
            return self._refcount

    @property
    def is_spillable(self) -> bool:
        with self._lock:
            return (self._refcount == 0 and not self._closed
                    and not self._spilling)

    # -- payload access ------------------------------------------------------
    @property
    def size_bytes(self) -> int:
        return self.meta.size_bytes

    def get_columnar_batch(self) -> ColumnarBatch:
        """Materialize as a device batch (possibly reading up the tiers)."""
        raise NotImplementedError

    def get_host_bytes(self) -> bytes:
        """Serialized payload (spill/shuffle wire form)."""
        raise NotImplementedError

    def free(self) -> None:
        """Release storage.  Only the owning store calls this."""
        with self._lock:
            self._closed = True


class DegenerateBuffer(SpillableBuffer):
    """Rows-but-no-columns batch — metadata only, never spills
    (reference DegenerateRapidsBuffer); materializes on `device`."""

    tier = StorageTier.DEVICE

    def __init__(self, bid: BufferId, meta: TableMeta, device):
        from spark_rapids_tpu_torch.columnar.vector import resolve_device
        super().__init__(bid, meta, spill_priority=float("inf"))
        self.device = resolve_device(device)

    @property
    def is_spillable(self) -> bool:
        return False

    def get_columnar_batch(self) -> ColumnarBatch:
        from spark_rapids_tpu_torch.columnar.batch import empty_batch
        b = empty_batch(self.meta.schema, self.device)
        return ColumnarBatch(b.schema, b.columns, self.meta.num_rows)

    def get_host_bytes(self) -> bytes:
        return b""


def meta_for_batch(batch: ColumnarBatch) -> TableMeta:
    return TableMeta(batch.schema, batch.num_rows,
                     batch.device_size_bytes())


def degenerate_meta(schema: T.Schema, num_rows: int) -> TableMeta:
    """rows-only meta (reference MetaUtils.buildDegenerateTableMeta:138)."""
    return TableMeta(schema, num_rows, 0)
