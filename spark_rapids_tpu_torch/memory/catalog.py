"""BufferCatalog: id -> buffer across tiers with refcounted acquisition
(port of spark_rapids_tpu/memory/catalog.py; reference
`RapidsBufferCatalog.scala`: acquireBuffer walks tiers; acquire pins the
buffer so it cannot spill mid-use).
"""
from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager

from spark_rapids_tpu_torch.memory.buffer import BufferId, SpillableBuffer


class BufferCatalog:
    def __init__(self):
        self._by_id: dict[BufferId, SpillableBuffer] = {}
        self._lock = threading.RLock()
        self._table_ids = itertools.count()

    def next_table_id(self) -> int:
        return next(self._table_ids)

    def register(self, buf: SpillableBuffer) -> None:
        with self._lock:
            # a buffer moving tiers re-registers under the same id; the
            # newest tier wins (reference updateTier semantics)
            self._by_id[buf.id] = buf

    def unregister(self, bid: BufferId) -> None:
        with self._lock:
            self._by_id.pop(bid, None)

    def acquire_buffer(self, bid: BufferId) -> SpillableBuffer:
        """Pin + return the buffer; caller must `close()` it.  Retries when
        the buffer migrates tiers between lookup and acquire (a spill in
        flight registers the next-tier copy before dropping this one, so a
        short wait always resolves)."""
        import time
        for attempt in range(1000):
            with self._lock:
                buf = self._by_id.get(bid)
            if buf is None:
                raise KeyError(f"unknown buffer {bid}")
            try:
                buf.add_reference()
            except ValueError:
                if attempt > 2:
                    time.sleep(0.001)  # spill mid-copy; wait for next tier
                continue
            if buf.store is not None:
                buf.store.mark_acquired(buf)
            return buf
        raise RuntimeError(f"could not acquire buffer {bid}")

    def release_buffer(self, buf: SpillableBuffer) -> None:
        buf.close()
        if buf.store is not None:
            buf.store.mark_released(buf)

    @contextmanager
    def acquired(self, bid: BufferId):
        buf = self.acquire_buffer(bid)
        try:
            yield buf
        finally:
            self.release_buffer(buf)

    def ids(self) -> list[BufferId]:
        with self._lock:
            return list(self._by_id)

    def is_registered(self, bid: BufferId) -> bool:
        with self._lock:
            return bid in self._by_id

    def remove(self, bid: BufferId) -> None:
        """Fully drop a buffer from whatever tier holds it."""
        with self._lock:
            buf = self._by_id.get(bid)
        if buf is not None and buf.store is not None:
            buf.store.remove(bid)
        else:
            self.unregister(bid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)
