"""Shuffle buffer catalogs over the tiered-store BufferCatalog (port of
spark_rapids_tpu/shuffle/catalog.py; reference `ShuffleBufferCatalog.scala`,
shuffleId -> blockId -> bufferIds for map outputs held in the device
store, and `ShuffleReceivedBufferCatalog.scala`, the reduce side's
received buffers).

Registration is per shuffle, so unregistering a shuffle frees every one
of its buffers in whatever tier holds it.
"""
from __future__ import annotations

import threading
from typing import Optional

from spark_rapids_tpu_torch.memory.buffer import BufferId, TableMeta
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog


class ShuffleBufferCatalog:
    """Map-side catalog: which buffer ids make up each shuffle block
    (shuffle_id, map_id, partition)."""

    def __init__(self, catalog: BufferCatalog):
        self.catalog = catalog
        self._lock = threading.Lock()
        # shuffle_id -> {(map_id, partition): [BufferId]}
        self._blocks: dict[int, dict[tuple[int, int], list[BufferId]]] = {}
        self._by_table: dict[int, BufferId] = {}

    def register_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            self._blocks.setdefault(shuffle_id, {})

    def next_shuffle_buffer_id(self, shuffle_id: int, map_id: int,
                               partition: int) -> BufferId:
        bid = BufferId(self.catalog.next_table_id(), shuffle_id, map_id,
                       partition)
        with self._lock:
            if shuffle_id not in self._blocks:
                raise ValueError(f"shuffle {shuffle_id} not registered")
            self._blocks[shuffle_id].setdefault(
                (map_id, partition), []).append(bid)
            self._by_table[bid.table_id] = bid
        return bid

    def lookup_table(self, table_id: int) -> BufferId:
        with self._lock:
            return self._by_table[table_id]

    def blocks_for_partition(self, shuffle_id: int, partition: int,
                             map_ids: Optional[list[int]] = None
                             ) -> list[BufferId]:
        with self._lock:
            blocks = self._blocks.get(shuffle_id, {})
            out = []
            for (m, p), bids in sorted(blocks.items()):
                if p != partition:
                    continue
                if map_ids is not None and m not in map_ids:
                    continue
                out.extend(bids)
            return out

    def meta_for(self, bid: BufferId) -> TableMeta:
        with self.catalog.acquired(bid) as buf:
            return buf.meta

    def remove_buffers(self, bids: list[BufferId]) -> None:
        """Remove EXACTLY these buffers (a failed or losing attempt's own
        writes).  With speculation or replicas two attempts' buffers can
        share one (map_id, partition) slot, and a loser's cleanup must
        never free the winner's data."""
        with self._lock:
            for bid in bids:
                blocks = self._blocks.get(bid.shuffle_id, {})
                lst = blocks.get((bid.map_id, bid.partition))
                if lst is not None and bid in lst:
                    lst.remove(bid)
                    if not lst:
                        del blocks[(bid.map_id, bid.partition)]
                self._by_table.pop(bid.table_id, None)
        for bid in bids:
            if self.catalog.is_registered(bid):
                self.catalog.remove(bid)

    def remove_task_buffers(self, shuffle_id: int, map_id: int) -> None:
        """Every buffer of one map task (reference RapidsCachingWriter
        cleanup of a superseded run)."""
        with self._lock:
            blocks = self._blocks.get(shuffle_id, {})
            doomed = [(k, v) for k, v in blocks.items() if k[0] == map_id]
            for k, bids in doomed:
                del blocks[k]
                for bid in bids:
                    self._by_table.pop(bid.table_id, None)
        for _, bids in doomed:
            for bid in bids:
                self.catalog.remove(bid)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            blocks = self._blocks.pop(shuffle_id, {})
            for bids in blocks.values():
                for bid in bids:
                    self._by_table.pop(bid.table_id, None)
        for bids in blocks.values():
            for bid in bids:
                self.catalog.remove(bid)


class ShuffleReceivedBufferCatalog:
    """Reduce-side catalog of buffers fetched from other executors
    (reference ShuffleReceivedBufferCatalog.scala), freed per task."""

    def __init__(self, catalog: BufferCatalog):
        self.catalog = catalog
        self._lock = threading.Lock()
        self._received: dict[int, list[BufferId]] = {}  # per task attempt

    def add_received(self, task_attempt_id: int, bid: BufferId) -> None:
        with self._lock:
            self._received.setdefault(task_attempt_id, []).append(bid)

    def new_buffer_id(self) -> BufferId:
        return BufferId(self.catalog.next_table_id())

    def take_task(self, task_attempt_id: int) -> list[BufferId]:
        """Detach a task attempt's received buffers WITHOUT freeing them
        (a hedged fetch's winner: its buffers move to the consuming
        reader's attempt id, whose release_task then frees them)."""
        with self._lock:
            return self._received.pop(task_attempt_id, [])

    def release_task(self, task_attempt_id: int) -> None:
        with self._lock:
            bids = self._received.pop(task_attempt_id, [])
        for bid in bids:
            if self.catalog.is_registered(bid):
                self.catalog.remove(bid)
