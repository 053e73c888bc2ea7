"""Tiered buffer stores: device -> host (arena) -> disk (port of
spark_rapids_tpu/memory/stores.py).

Reference parallels: `RapidsBufferStore.scala:39-341` (abstract store with
spill-priority tracking + `setSpillStore` chaining + `synchronousSpill`),
`RapidsDeviceMemoryStore.scala`, `RapidsHostMemoryStore.scala` (pool carved
by AddressSpaceAllocator), `RapidsDiskStore.scala` (disk block manager
files).

The device tier holds live batches of torch tensors on the card; spilling
serializes the batch (columnar/serde.py: a synchronous device-to-host copy
of its live rows) and pushes the blob down the chain.  Reading a spilled
buffer re-uploads it to the store's device, which every store is given.
The spill-candidate order is kept in the native HashedPriorityQueue.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.serde import (deserialize_batch,
                                                   serialize_batch)
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.memory.buffer import (
    BufferId, SpillableBuffer, StorageTier, TableMeta)
from spark_rapids_tpu_torch.utils import residency as RES
from spark_rapids_tpu_torch.memory.native import (HashedPriorityQueue,
                                                  HostArena,
                                                  SpillCorruptionError)

#: the descriptive integrity failure a corrupted spill file surfaces on
#: re-read (instead of deserializing garbage) — re-exported here since
#: the write/verify sites live in this module's disk tier
SpillCorruption = SpillCorruptionError


# ---------------------------------------------------------------------------
# seeded spill-corruption injection: flips one payload byte in a
# freshly written spill file (AFTER the CRC frame landed, like real
# disk rot), proving the CRC-verified re-read raises SpillCorruption
# rather than handing a poisoned batch downstream.  Keyed per
# (rate, seed) like the OOM injectors, so concurrent queries with
# different injection confs drive independent deterministic streams.
_SPILL_INJ_LOCK = threading.Lock()
_SPILL_INJ_RNGS: dict = {}
_SPILL_INJ_COUNT = [0]
#: spill-file frame header: magic(4) + version(4) + len(8) + crc(4) —
#: the flipped byte must land in the payload, not the header, so the
#: CRC check (not a magic/length check) is what catches it
_SPILL_FRAME_HEADER = 20


def reset_spill_corruption() -> None:
    with _SPILL_INJ_LOCK:
        _SPILL_INJ_RNGS.clear()
        _SPILL_INJ_COUNT[0] = 0


def injected_spill_corruptions() -> int:
    with _SPILL_INJ_LOCK:
        return _SPILL_INJ_COUNT[0]


def _maybe_corrupt_spill_file(path: str, payload_len: int) -> None:
    import random

    from spark_rapids_tpu_torch import config as C
    conf = C.get_active_conf()
    rate = float(conf[C.SPILL_CORRUPT_RATE])
    if rate <= 0 or payload_len <= 0:
        return
    seed = int(conf[C.OOM_INJECT_SEED])
    with _SPILL_INJ_LOCK:
        rng = _SPILL_INJ_RNGS.get((rate, seed))
        if rng is None:
            rng = _SPILL_INJ_RNGS[(rate, seed)] = random.Random(seed)
        if rng.random() >= rate:
            return
        offset = _SPILL_FRAME_HEADER + rng.randrange(payload_len)
        _SPILL_INJ_COUNT[0] += 1
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


class BufferStore:
    """Abstract tier: tracks buffers + spill candidates; chains to the next
    tier via `set_spill_store` (reference RapidsBufferStore.setSpillStore)."""

    tier: StorageTier

    def __init__(self, catalog=None):
        self.catalog = catalog
        self._buffers: dict[BufferId, SpillableBuffer] = {}
        self._handle_of: dict[int, BufferId] = {}
        self._spill_queue = HashedPriorityQueue()
        self._lock = threading.RLock()
        self.spill_store: Optional["BufferStore"] = None
        self.current_size = 0
        #: the most bytes resident at once since the last reset_peak()
        self.peak_size = 0
        #: bytes ever stored at this tier (a spill report's per-tier sum)
        self.bytes_added = 0

    def set_spill_store(self, store: "BufferStore") -> None:
        self.spill_store = store

    # -- registration --------------------------------------------------------
    def _track(self, buf: SpillableBuffer) -> None:
        with self._lock:
            self._buffers[buf.id] = buf
            buf.store = self
            self.current_size += buf.size_bytes
            self.peak_size = max(self.peak_size, self.current_size)
            self.bytes_added += buf.size_bytes
            h = id(buf)
            self._handle_of[h] = buf.id
            buf._spill_handle = h
            if buf.is_spillable:
                self._spill_queue.offer(h, buf.spill_priority)
            if self.catalog is not None:
                self.catalog.register(buf)
            # residency ledger (utils/residency.py): every tracked buffer
            # carries provenance (query id, site, tier) from birth to
            # free/spill
            if RES.enabled():
                buf._res_token = RES.track(
                    buf.size_bytes, site=RES.buffer_site(buf.id),
                    tier=self.tier.name.lower(), kind=RES.KIND_STORE)

    def remove(self, bid: BufferId) -> None:
        with self._lock:
            buf = self._buffers.pop(bid, None)
            if buf is None:
                return
            self.current_size -= buf.size_bytes
            h = getattr(buf, "_spill_handle", None)
            if h is not None:
                self._spill_queue.remove(h)
                self._handle_of.pop(h, None)
            self._on_remove(buf)
            buf.free()
            RES.retire(getattr(buf, "_res_token", None))
            buf._res_token = None
            if self.catalog is not None:
                self.catalog.unregister(bid)

    def _on_remove(self, buf: SpillableBuffer) -> None:
        """Tier-specific accounting, called under the store lock exactly
        once per successful removal."""

    def get(self, bid: BufferId) -> Optional[SpillableBuffer]:
        with self._lock:
            return self._buffers.get(bid)

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_size = self.current_size

    def stats(self) -> dict:
        """Resident bytes + buffer count for this tier (telemetry
        gauge; `current_size` alone races the buffer table)."""
        with self._lock:
            return {"bytes": self.current_size,
                    "buffers": len(self._buffers)}

    def mark_acquired(self, buf: SpillableBuffer) -> None:
        """Pinned buffers leave the spill queue."""
        h = getattr(buf, "_spill_handle", None)
        if h is not None:
            self._spill_queue.remove(h)

    def mark_released(self, buf: SpillableBuffer) -> None:
        if buf.is_spillable:
            h = getattr(buf, "_spill_handle", None)
            if h is not None:
                self._spill_queue.offer(h, buf.spill_priority)

    def update_priority(self, buf: SpillableBuffer, priority: float) -> None:
        buf.spill_priority = priority
        h = getattr(buf, "_spill_handle", None)
        if h is not None and h in self._spill_queue:
            self._spill_queue.update_priority(h, priority)

    # -- spilling ------------------------------------------------------------
    def synchronous_spill(self, target_size: int) -> int:
        """Spill lowest-priority buffers until `current_size <= target_size`.
        Returns bytes freed (reference RapidsBufferStore.synchronousSpill)."""
        import time

        from spark_rapids_tpu_torch.utils import movement as MV
        freed = 0
        while True:
            with self._lock:
                if self.current_size <= target_size:
                    break
                h = self._spill_queue.poll()
                if h is None:
                    break  # nothing spillable left
                bid = self._handle_of.get(h)
                buf = self._buffers.get(bid) if bid is not None else None
                # claim atomically: a reader that pinned the buffer after
                # it entered the spill queue wins, and the buffer stays
                if buf is None or not buf.try_mark_spilling():
                    continue
            if self.spill_store is not None:
                t0 = time.perf_counter_ns()
                # the next-tier copy inherits the ORIGINAL owner's
                # provenance: a pressure spill triggered by query B never
                # re-attributes query A's bytes
                with RES.inherit_scope(getattr(buf, "_res_token", None)):
                    dst = self.spill_store.copy_buffer(buf)
                # one ledger record PER HOP, the hop that happened (a
                # host pool that is full falls through: device->disk);
                # bytes = this tier's accounted size (what spillBytes and
                # bytes_spilled count), raw = the blob that landed
                if MV.ledger() is not None:
                    MV.record(
                        MV.EDGE_SPILL, buf.size_bytes,
                        site=f"{self.tier.name.lower()}->"
                             f"{dst.tier.name.lower()}",
                        raw_bytes=dst.size_bytes,
                        dur_ns=time.perf_counter_ns() - t0)
            freed += buf.size_bytes
            self.remove_from_tier_only(buf)
        return freed

    def remove_from_tier_only(self, buf: SpillableBuffer) -> None:
        """Drop from this tier without unregistering from the catalog
        (the buffer lives on in the spill store)."""
        with self._lock:
            if self._buffers.pop(buf.id, None) is not None:
                self.current_size -= buf.size_bytes
                self._on_remove(buf)
            h = getattr(buf, "_spill_handle", None)
            if h is not None:
                self._handle_of.pop(h, None)
            buf.free()
            RES.retire(getattr(buf, "_res_token", None))
            buf._res_token = None

    def copy_buffer(self, buf: SpillableBuffer) -> SpillableBuffer:
        """Materialize `buf`'s payload at this tier (spill receive path)."""
        raise NotImplementedError

    @property
    def spillable_size(self) -> int:
        with self._lock:
            return sum(b.size_bytes for b in self._buffers.values()
                       if b.is_spillable)

    def close(self) -> None:
        with self._lock:
            for bid in list(self._buffers):
                self.remove(bid)


# ---------------------------------------------------------------------------
class DeviceBuffer(SpillableBuffer):
    tier = StorageTier.DEVICE

    def __init__(self, bid: BufferId, batch: ColumnarBatch, meta: TableMeta,
                 spill_priority: float):
        super().__init__(bid, meta, spill_priority)
        self._batch = batch

    def get_columnar_batch(self) -> ColumnarBatch:
        return self._batch

    def get_host_bytes(self) -> bytes:
        return serialize_batch(self._batch)

    def free(self) -> None:
        super().free()
        self._batch = None  # drop the device tensors


class DeviceMemoryStore(BufferStore):
    """Device tier (reference RapidsDeviceMemoryStore.addTable/addBuffer)."""

    tier = StorageTier.DEVICE

    def __init__(self, catalog=None, device_manager=None, device="cuda"):
        super().__init__(catalog)
        self.device_manager = device_manager
        self.device = resolve_device(device)

    def add_batch(self, bid: BufferId, batch: ColumnarBatch,
                  spill_priority: float = 0.0) -> DeviceBuffer:
        from spark_rapids_tpu_torch.memory.buffer import meta_for_batch
        meta = meta_for_batch(batch)
        buf = DeviceBuffer(bid, batch, meta, spill_priority)
        if self.device_manager is not None:
            self.device_manager.track_store_bytes(
                meta.size_bytes, site="device-store.add")
        self._track(buf)
        return buf

    def _on_remove(self, buf: SpillableBuffer) -> None:
        if self.device_manager is not None:
            self.device_manager.track_store_bytes(
                -buf.size_bytes, site="device-store.remove")

    def copy_buffer(self, buf: SpillableBuffer) -> SpillableBuffer:
        batch = buf.get_columnar_batch()
        return self.add_batch(buf.id, batch, buf.spill_priority)


# ---------------------------------------------------------------------------
class HostBuffer(SpillableBuffer):
    tier = StorageTier.HOST

    def __init__(self, bid: BufferId, store: "HostMemoryStore", offset: int,
                 length: int, meta: TableMeta, spill_priority: float):
        super().__init__(bid, meta, spill_priority)
        self._host_store = store
        self._offset = offset
        self._length = length

    def get_host_bytes(self) -> bytes:
        return self._host_store.arena.read(self._offset, self._length)

    def get_columnar_batch(self) -> ColumnarBatch:
        return deserialize_batch(self.get_host_bytes(),
                                 self._host_store.device)

    def free(self) -> None:
        super().free()
        self._host_store.arena.allocator.free(self._offset)

    @property
    def size_bytes(self) -> int:
        return self._length


class HostMemoryStore(BufferStore):
    """Host tier: fixed pool carved by the native first-fit allocator
    (reference RapidsHostMemoryStore + AddressSpaceAllocator.scala).  When
    the pool cannot fit a blob, it passes straight down to the spill store
    (the reference's host-store behavior on allocation failure)."""

    tier = StorageTier.HOST

    def __init__(self, size: int, catalog=None, device="cuda"):
        super().__init__(catalog)
        self.arena = HostArena(size)
        #: where a buffer read back from this tier is uploaded
        self.device = resolve_device(device)

    def copy_buffer(self, buf: SpillableBuffer) -> SpillableBuffer:
        return self._add(buf.id, buf.get_host_bytes, buf.meta,
                         buf.spill_priority,
                         lambda: self.spill_store.copy_buffer(buf))

    def add_blob(self, bid: BufferId, blob: bytes, meta: TableMeta,
                 spill_priority: float = 0.0) -> SpillableBuffer:
        """Store an already-serialized batch (shuffle receive path —
        reference ShuffleReceivedBufferCatalog adds to the host tier)."""
        return self._add(
            bid, lambda: blob, meta, spill_priority,
            lambda: self.spill_store.add_blob(bid, blob, meta,
                                              spill_priority))

    def _add(self, bid: BufferId, get_blob, meta: TableMeta,
             spill_priority: float, fall_through) -> SpillableBuffer:
        blob = get_blob()
        off = self.arena.allocator.allocate(len(blob))
        if off is None:
            # try to make room by spilling our own contents downward
            if self.spill_store is not None:
                self.synchronous_spill(
                    max(0, self.current_size - len(blob)))
                off = self.arena.allocator.allocate(len(blob))
            if off is None:
                if self.spill_store is None:
                    raise MemoryError(
                        f"host store full ({len(blob)} bytes needed)")
                return fall_through()
        self.arena.write(off, blob)
        hb = HostBuffer(bid, self, off, len(blob), meta, spill_priority)
        self._track(hb)
        return hb


# ---------------------------------------------------------------------------
class DiskBlockManager:
    """Maps buffer ids to spill files in a managed temp dir (reference
    RapidsDiskBlockManager over Spark's disk block manager)."""

    def __init__(self, root: Optional[str] = None):
        import tempfile
        self.root = root or tempfile.mkdtemp(prefix="tpu-spill-")
        os.makedirs(self.root, exist_ok=True)

    def path_for(self, bid: BufferId) -> str:
        return os.path.join(
            self.root,
            f"t{bid.table_id}_s{bid.shuffle_id}_m{bid.map_id}"
            f"_p{bid.partition}.bin")

    def cleanup(self) -> None:
        import shutil
        shutil.rmtree(self.root, ignore_errors=True)


class DiskBuffer(SpillableBuffer):
    tier = StorageTier.DISK

    def __init__(self, bid: BufferId, path: str, length: int, meta: TableMeta,
                 spill_priority: float):
        super().__init__(bid, meta, spill_priority)
        self._path = path
        self._length = length

    def get_host_bytes(self) -> bytes:
        # CRC-verified read: corruption surfaces as SpillCorruptionError
        # instead of a poisoned batch (memory/native spill framing)
        import time

        from spark_rapids_tpu_torch.memory.native import spill_read
        from spark_rapids_tpu_torch.utils import movement as MV
        t0 = time.perf_counter_ns()
        blob = spill_read(self._path)
        if MV.ledger() is not None:
            MV.record(MV.EDGE_SPILL, len(blob), site="disk->host",
                      dur_ns=time.perf_counter_ns() - t0)
        return blob

    def get_columnar_batch(self) -> ColumnarBatch:
        return deserialize_batch(self.get_host_bytes(), self.store.device)

    def free(self) -> None:
        super().free()
        try:
            os.unlink(self._path)
        except FileNotFoundError:
            pass
        except OSError:
            # teardown race (directory concurrently swept, file still
            # mapped, ...): hand the path to the owning store so
            # close() retries the unlink instead of leaking the spill
            # file on disk forever
            store = self.store
            if store is not None and hasattr(store, "_note_orphan"):
                store._note_orphan(self._path)

    @property
    def size_bytes(self) -> int:
        return self._length

    @property
    def is_spillable(self) -> bool:
        return False  # bottom tier


class DiskStore(BufferStore):
    tier = StorageTier.DISK

    def __init__(self, block_manager: Optional[DiskBlockManager] = None,
                 catalog=None, device="cuda"):
        super().__init__(catalog)
        #: where a buffer read back from this tier is uploaded
        self.device = resolve_device(device)
        self.block_manager = block_manager or DiskBlockManager()
        #: unlink-failed paths from freed buffers (teardown races) —
        #: close() retries these so nothing leaks on disk
        self._orphans: set[str] = set()
        #: corrupt spill files set aside by quarantine(): preserved
        #: for triage until close(), never re-readable as data
        self._quarantined: set[str] = set()

    def _note_orphan(self, path: str) -> None:
        with self._lock:
            self._orphans.add(path)

    def quarantine(self, bid: BufferId) -> Optional[str]:
        """Corrupt-spill handling (memory/oocore.py): pull the buffer
        out of the store and rename its file to `*.quarantined`, so
        the poisoned bytes survive for triage but can never be
        re-read as data.  Returns the quarantined path, or None when
        the buffer is not resident at this tier."""
        with self._lock:
            buf = self._buffers.pop(bid, None)
            if buf is None:
                return None
            self.current_size -= buf.size_bytes
            h = getattr(buf, "_spill_handle", None)
            if h is not None:
                self._spill_queue.remove(h)
                self._handle_of.pop(h, None)
        qpath = buf._path + ".quarantined"
        try:
            os.replace(buf._path, qpath)
        except OSError:
            qpath = buf._path  # rename failed: track the original
        with self._lock:
            self._quarantined.add(qpath)
        # mark closed WITHOUT DiskBuffer.free()'s unlink — the
        # quarantined file must survive until close()
        SpillableBuffer.free(buf)
        RES.retire(getattr(buf, "_res_token", None))
        buf._res_token = None
        if self.catalog is not None:
            self.catalog.unregister(bid)
        return qpath

    def orphaned_spill_files(self) -> list[str]:
        """Spill files in the block manager's directory that no live
        buffer owns and that are not quarantined — freed-buffer unlink
        leaks.  The teardown leak checks assert this is empty."""
        with self._lock:
            owned = {b._path for b in self._buffers.values()}
            quarantined = set(self._quarantined)
        try:
            names = os.listdir(self.block_manager.root)
        except OSError:
            return []
        out = []
        for name in names:
            p = os.path.join(self.block_manager.root, name)
            if p not in owned and p not in quarantined:
                out.append(p)
        return sorted(out)

    def copy_buffer(self, buf: SpillableBuffer) -> SpillableBuffer:
        return self.add_blob(buf.id, buf.get_host_bytes(), buf.meta,
                             buf.spill_priority)

    def add_blob(self, bid: BufferId, blob: bytes, meta: TableMeta,
                 spill_priority: float = 0.0) -> SpillableBuffer:
        from spark_rapids_tpu_torch.memory.native import spill_write
        path = self.block_manager.path_for(bid)
        # CRC-framed + fsync'd (native runtime.cpp; the role the JVM's
        # checksummed spill writers play in the reference stack)
        spill_write(path, blob)
        # seeded integrity-failure injection (device->disk and
        # host->disk both land here): the re-read must surface
        # SpillCorruption, never a garbage batch
        _maybe_corrupt_spill_file(path, len(blob))
        db = DiskBuffer(bid, path, len(blob), meta, spill_priority)
        self._track(db)
        return db

    def close(self) -> None:
        super().close()
        # explicitly drain quarantined + orphaned files: cleanup()'s
        # ignore_errors rmtree used to hide these leaks — now the
        # directory is emptied file-by-file first, so a post-close
        # scan (or a failed rmtree) can prove it really drained
        with self._lock:
            leftovers = self._orphans | self._quarantined
            self._orphans.clear()
            self._quarantined.clear()
        for p in leftovers | set(self.orphaned_spill_files()):
            try:
                os.unlink(p)
            except OSError:
                pass
        self.block_manager.cleanup()
