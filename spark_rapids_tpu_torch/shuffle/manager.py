"""The accelerated shuffle manager: a caching writer and reader over the
spillable catalog and the transport (port of
spark_rapids_tpu/shuffle/manager.py; reference
`RapidsShuffleInternalManager.scala`: `RapidsCachingWriter` keeps a map
output in the device store, spillable, and its MapStatus advertises the
transport address; `RapidsCachingReader` reads local partitions straight
from the catalog and fetches remote ones; `RapidsShuffleIterator`
orchestrates the fetches, takes the semaphore to materialize and turns a
timeout into a FetchFailed).

`MapOutputRegistry` plays Spark's MapOutputTracker (map task ->
executor, per-partition sizes) with the recovery surface: per-shuffle
epochs, invalidation by address, and the partial-read guard.  Executors
register here, so one process runs many of them: four executors of one
card, in chip_smoke.py's phase 16, as a four-executor cluster would.

Device streams: a map task writes on its thread's CUDA stream, and its
slices may be read by a transport thread on another.  The writer records
a CUDA event with each device buffer (`ready_event`, `ready_device`),
which the server waits on before it copies the buffer to the host
(shuffle/client_server.py).  A fetched buffer lands in the host store and
is brought to the reader's device on the reader's thread and stream.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Iterator, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.buffer import (BufferId, DegenerateBuffer,
                                                  degenerate_meta)
from spark_rapids_tpu_torch.memory.env import ResourceEnv
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.spill_priorities import (
    OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY)
from spark_rapids_tpu_torch.shuffle.catalog import (
    ShuffleBufferCatalog, ShuffleReceivedBufferCatalog)
from spark_rapids_tpu_torch.shuffle.client_server import (
    FetchFailedError, ShuffleClient, ShuffleReceiveHandler, ShuffleServer)
from spark_rapids_tpu_torch.shuffle.transport import (BlockIdMsg,
                                                      make_transport)

log = logging.getLogger("spark_rapids_tpu_torch.shuffle")


class MapStatus:
    """Map-task completion record (reference MapStatus with the transport
    address in BlockManagerId.topologyInfo).  It carries BOTH the loopback
    and the TCP address: readers in this process take the loopback lane,
    readers in another fall back to the wire."""

    def __init__(self, executor_id: str, address: str,
                 partition_sizes: list[int],
                 tcp_address: Optional[str] = None,
                 replicas: Optional[list[tuple]] = None):
        self.executor_id = executor_id
        self.address = address
        self.partition_sizes = partition_sizes
        self.tcp_address = tcp_address
        #: backup executors holding a serialized copy of this map output
        #: (spark.rapids.shuffle.replication.factor >= 2):
        #: [(executor_id, loop_address, tcp_address), ...].  Hedged
        #: fetches race one against a slow primary; recovery promotes one
        #: on peer loss instead of recomputing.
        self.replicas = list(replicas or [])
        #: the registry epoch this status was registered under
        self.epoch = 0

    def addresses(self) -> list[str]:
        return [a for a in (self.address, self.tcp_address) if a]

    def hedge_address(self, transport, health=None) -> Optional[str]:
        """A replica address to hedge a slow primary fetch against:
        reachable on this transport and not blacklisted, or None."""
        for _eid, addr, tcp in self.replicas:
            for a in (addr, tcp):
                if not a or not transport.can_reach(a):
                    continue
                if health is not None and health.is_blacklisted(a):
                    continue
                return a
        return None

    def reachable_address(self, transport, health=None) -> str:
        """The lane to fetch from: loopback where it resolves in this
        process, the wire otherwise, and around blacklisted addresses
        when a PeerHealth tracker is given."""
        cands = self.addresses()
        reach = [a for a in cands if transport.can_reach(a)] or cands
        if health is not None:
            ok = [a for a in reach if not health.is_blacklisted(a)]
            if ok:
                reach = ok
        return reach[0]


class StaleMapStatusError(Exception):
    """A MapStatus registration carried a superseded epoch: the shuffle's
    outputs were invalidated after the producing map run started, so its
    result must not be served to reducers."""


class MapOutputRegistry:
    """Driver-side map output tracker (process-global), Spark's
    MapOutputTracker with its recovery surface: per-shuffle epochs,
    bumped on every invalidation so stale registrations are refused;
    invalidation by executor address (FetchFailed ->
    unregisterMapOutput); and an expected map count, so a read over an
    incomplete output set fails instead of returning partial data.  Every
    entry is keyed by its process-unique shuffle id, so concurrent
    queries never share one."""

    _lock = threading.Lock()
    _outputs: dict[int, dict[int, MapStatus]] = {}
    _epochs: dict[int, int] = {}
    _expected: dict[int, int] = {}

    @classmethod
    def register(cls, shuffle_id: int, map_id: int,
                 status: MapStatus, epoch: Optional[int] = None,
                 first_wins: bool = False) -> None:
        """`first_wins` (speculative attempts) makes the registration
        atomic-or-reject: when the map output is already committed at the
        current epoch the caller LOST the race and must not publish."""
        with cls._lock:
            cur = cls._epochs.get(shuffle_id, 0)
            if epoch is not None and epoch != cur:
                raise StaleMapStatusError(
                    f"map output {shuffle_id}/{map_id} registered at "
                    f"epoch {epoch} but the shuffle is at epoch {cur}: "
                    f"the producing map run was superseded by a "
                    f"recovery invalidation")
            outs = cls._outputs.setdefault(shuffle_id, {})
            if first_wins and map_id in outs:
                err = StaleMapStatusError(
                    f"map output {shuffle_id}/{map_id} was already "
                    f"committed by a faster attempt (first-wins "
                    f"speculation): this attempt lost the race")
                err.race_lost = True
                raise err
            status.epoch = cur
            outs[map_id] = status

    @classmethod
    def outputs_for(cls, shuffle_id: int) -> dict[int, MapStatus]:
        with cls._lock:
            return dict(cls._outputs.get(shuffle_id, {}))

    @classmethod
    def epoch(cls, shuffle_id: int) -> int:
        with cls._lock:
            return cls._epochs.get(shuffle_id, 0)

    @classmethod
    def set_expected_maps(cls, shuffle_id: int, num_maps: int) -> None:
        """Arm the partial-read guard of `missing_maps`."""
        with cls._lock:
            cls._expected[shuffle_id] = num_maps

    @classmethod
    def missing_maps(cls, shuffle_id: int) -> list[int]:
        """Map ids invalidated and not yet recomputed (empty when no
        expected count was declared)."""
        with cls._lock:
            n = cls._expected.get(shuffle_id)
            if n is None:
                return []
            outs = cls._outputs.get(shuffle_id, {})
            return [m for m in range(n) if m not in outs]

    @classmethod
    def invalidate_address(cls, shuffle_id: int, address: str
                           ) -> dict[int, MapStatus]:
        """Drop every map output of the executor(s) advertising `address`
        and bump the shuffle's epoch; returns the removed outputs."""
        with cls._lock:
            outs = cls._outputs.get(shuffle_id, {})
            execs = {s.executor_id for s in outs.values()
                     if address in (s.address, s.tcp_address)}
            lost = {m: s for m, s in outs.items()
                    if s.executor_id in execs}
            for m in lost:
                del outs[m]
            if lost:
                cls._epochs[shuffle_id] = cls._epochs.get(shuffle_id, 0) + 1
            return lost

    @classmethod
    def invalidate_others(cls, shuffle_id: int, keep_executor_id: str
                          ) -> dict[int, MapStatus]:
        """Fallback for a failure no address accounts for: drop every map
        output NOT owned by `keep_executor_id` (the reducer) and bump the
        epoch."""
        with cls._lock:
            outs = cls._outputs.get(shuffle_id, {})
            lost = {m: s for m, s in outs.items()
                    if s.executor_id != keep_executor_id}
            for m in lost:
                del outs[m]
            if lost:
                cls._epochs[shuffle_id] = cls._epochs.get(shuffle_id, 0) + 1
            return lost

    @classmethod
    def unregister_shuffle(cls, shuffle_id: int) -> None:
        with cls._lock:
            cls._outputs.pop(shuffle_id, None)
            cls._epochs.pop(shuffle_id, None)
            cls._expected.pop(shuffle_id, None)

    @classmethod
    def live_shuffles(cls) -> int:
        with cls._lock:
            return len(cls._outputs.keys() | cls._expected.keys())

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._outputs.clear()
            cls._epochs.clear()
            cls._expected.clear()


class TpuShuffleManager:
    """Executor-side shuffle environment (reference GpuShuffleEnv and
    RapidsShuffleInternalManagerBase) over the process's ResourceEnv."""

    # RLock: get_or_create constructs under the lock and the constructor
    # takes it again to register itself
    _registry_lock = threading.RLock()
    _managers: dict[str, "TpuShuffleManager"] = {}

    def __init__(self, executor_id: str,
                 env: Optional[ResourceEnv] = None,
                 conf: Optional[C.RapidsConf] = None, device=None):
        self.executor_id = executor_id
        self.conf = conf or C.get_active_conf()
        self.env = env or ResourceEnv.get(device)
        self.shuffle_catalog = ShuffleBufferCatalog(self.env.catalog)
        self.received_catalog = ShuffleReceivedBufferCatalog(
            self.env.catalog)
        self.transport = make_transport(self.conf)
        from spark_rapids_tpu_torch.shuffle.compression import (
            codec_from_conf)
        self.server = ShuffleServer(self.shuffle_catalog, self.transport,
                                    codec=codec_from_conf(self.conf),
                                    executor_id=executor_id)
        handle = self.transport.make_server(executor_id, self.server)
        self.loop_address = handle.loop_address
        self.tcp_address = handle.tcp_address
        with TpuShuffleManager._registry_lock:
            TpuShuffleManager._managers[executor_id] = self

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def get(cls, executor_id: str) -> Optional["TpuShuffleManager"]:
        with cls._registry_lock:
            return cls._managers.get(executor_id)

    @classmethod
    def live_executors(cls) -> int:
        """Registered shuffle executors of this process."""
        with cls._registry_lock:
            return len(cls._managers)

    @classmethod
    def get_or_create(cls, executor_id: str,
                      env: Optional[ResourceEnv] = None,
                      conf: Optional[C.RapidsConf] = None,
                      device=None) -> "TpuShuffleManager":
        """ATOMIC get-or-create: a `get(id) or Manager(id)` idiom raced
        under concurrent queries, and the second server's loopback
        registration replaced the first's, whose catalog then answered
        fetches with no tables (silent partial data).  A manager over an
        environment that was shut down since is replaced.  A new manager
        is of the class this is called on (a per-version
        RapidsShuffleManager of shims/); an existing one is returned
        whatever its class."""
        with cls._registry_lock:
            m = cls._managers.get(executor_id)
            if m is not None and env is None \
                    and m.env is not ResourceEnv.peek():
                m.close()
                m = None
            if m is None:
                m = cls(executor_id, env, conf, device)
            return m

    @classmethod
    def close_all(cls) -> None:
        """Close every executor of this process."""
        with cls._registry_lock:
            managers = list(cls._managers.values())
        for m in managers:
            m.close()

    def close(self) -> None:
        self.transport.shutdown()
        with TpuShuffleManager._registry_lock:
            if TpuShuffleManager._managers.get(self.executor_id) is self:
                TpuShuffleManager._managers.pop(self.executor_id)

    def register_shuffle(self, shuffle_id: int) -> None:
        self.shuffle_catalog.register_shuffle(shuffle_id)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self.shuffle_catalog.unregister_shuffle(shuffle_id)
        MapOutputRegistry.unregister_shuffle(shuffle_id)

    # -- write side ----------------------------------------------------------
    def get_writer(self, shuffle_id: int, map_id: int,
                   replicas: Sequence["TpuShuffleManager"] = ()
                   ) -> "CachingShuffleWriter":
        return CachingShuffleWriter(self, shuffle_id, map_id,
                                    replicas=replicas)

    # -- read side -----------------------------------------------------------
    _attempt_ids = itertools.count(1)

    def get_reader(self, shuffle_id: int, partition: int,
                   task_attempt_id: Optional[int] = None,
                   timeout: float = 30.0,
                   with_map_ids: bool = False,
                   metrics=None) -> Iterator:
        """One reduce partition's batches.  `with_map_ids` yields
        (map_id, batch) pairs, so a recovery-aware consumer can restore
        the map order after a recompute moved outputs between executors.
        `metrics` (the exchange's MetricSet) is charged the wire bytes,
        compressed and not, and the wire corruptions caught."""
        if task_attempt_id is None:
            # unique per reader, so one reader's receive cleanup never
            # frees a concurrent reader's buffers
            task_attempt_id = next(TpuShuffleManager._attempt_ids)
        it = CachingShuffleReader(self, shuffle_id, partition,
                                  task_attempt_id, timeout,
                                  metrics=metrics).read()
        if with_map_ids:
            return it
        return (b for _, b in it)


class CachingShuffleWriter:
    """Stores each partition slice in the device store through the
    shuffle catalog; a degenerate (rows-only) batch is stored as metadata
    alone (reference RapidsCachingWriter.write :74-191).

    With `replicas` (spark.rapids.shuffle.replication.factor >= 2) each
    slice's serialized payload also goes into every replica executor's
    host store, and the MapStatus advertises them.  Cleanup is scoped to
    the buffers this writer made, so a losing speculative attempt never
    frees a winner's buffers in the same (map_id, partition) slot."""

    def __init__(self, manager: TpuShuffleManager, shuffle_id: int,
                 map_id: int, replicas: Sequence[TpuShuffleManager] = ()):
        self.manager = manager
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.replicas = [r for r in replicas if r is not manager]
        self._sizes: dict[int, int] = {}
        #: every buffer this writer made, with its catalog
        self._written: list[tuple] = []
        self.replicated_bytes = 0

    def write_partition(self, partition: int, batch: ColumnarBatch) -> None:
        cat = self.manager.shuffle_catalog
        bid = cat.next_shuffle_buffer_id(self.shuffle_id, self.map_id,
                                         partition)
        self._written.append((cat, bid))
        if not batch.columns:
            meta = degenerate_meta(batch.schema, batch.num_rows)
            cat.catalog.register(DegenerateBuffer(bid, meta, batch.device))
            self._sizes[partition] = 0
            for r in self.replicas:
                rbid = r.shuffle_catalog.next_shuffle_buffer_id(
                    self.shuffle_id, self.map_id, partition)
                r.shuffle_catalog.catalog.register(
                    DegenerateBuffer(rbid, meta, batch.device))
                self._written.append((r.shuffle_catalog, rbid))
            return
        buf = self.manager.env.device_store.add_batch(
            bid, batch, OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY)
        if batch.device.type == "cuda":
            import torch
            # the slice's tensors are done once this stream reaches the
            # event: a serving thread on another stream waits on it
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(batch.device))
            buf.ready_event, buf.ready_device = ev, batch.device
        self._sizes[partition] = self._sizes.get(partition, 0) + \
            buf.size_bytes
        if self.replicas:
            self._replicate(partition, batch)

    def _replicate(self, partition: int, batch: ColumnarBatch) -> None:
        """One slice's serialized payload into every replica executor's
        host store (serialized once)."""
        from spark_rapids_tpu_torch.columnar.serde import serialize_batch
        from spark_rapids_tpu_torch.memory.buffer import meta_for_batch
        from spark_rapids_tpu_torch.utils import movement as MV
        from spark_rapids_tpu_torch.utils import residency as RES
        blob = serialize_batch(batch)
        meta = meta_for_batch(batch)
        for r in self.replicas:
            rbid = r.shuffle_catalog.next_shuffle_buffer_id(
                self.shuffle_id, self.map_id, partition)
            # provenance: replica copies are not the primary map output;
            # their residency shows under a site of their own
            with RES.site_scope("shuffle-replica"):
                r.env.host_store.add_blob(rbid, blob, meta)
            self._written.append((r.shuffle_catalog, rbid))
            self.replicated_bytes += len(blob)
        if MV.ledger() is not None:
            MV.record(MV.EDGE_WIRE, len(blob) * len(self.replicas),
                      site="replicate")

    def commit(self, num_partitions: int, epoch: Optional[int] = None,
               first_wins: bool = False) -> MapStatus:
        """Register the map output.  `epoch` (recovery recomputes) pins it
        to the epoch the recompute was planned under: a later
        invalidation makes the commit stale, and the written buffers are
        freed.  `first_wins` (speculative attempts) also refuses it when
        a sibling attempt published first."""
        status = MapStatus(
            self.manager.executor_id, self.manager.loop_address,
            [self._sizes.get(p, 0) for p in range(num_partitions)],
            tcp_address=self.manager.tcp_address,
            replicas=[(r.executor_id, r.loop_address, r.tcp_address)
                      for r in self.replicas])
        try:
            MapOutputRegistry.register(self.shuffle_id, self.map_id,
                                       status, epoch=epoch,
                                       first_wins=first_wins)
        except StaleMapStatusError as e:
            self.abort()
            if not getattr(e, "race_lost", False):
                # superseded by an invalidation: also sweep the older
                # run's buffers of this map task, which nothing else
                # frees before unregister.  A lost first-wins race must
                # not: the winner's buffers share this slot.
                self.manager.shuffle_catalog.remove_task_buffers(
                    self.shuffle_id, self.map_id)
            raise
        return status

    def abort(self) -> None:
        """Failed-task cleanup (reference :159-167): frees exactly the
        buffers THIS writer made, primary and replicas."""
        by_cat: dict[int, tuple] = {}
        for cat, bid in self._written:
            by_cat.setdefault(id(cat), (cat, []))[1].append(bid)
        for cat, bids in by_cat.values():
            cat.remove_buffers(bids)
        self._written.clear()


class _IteratorHandler(ShuffleReceiveHandler):
    def __init__(self, q: "queue.Queue", current: dict,
                 wire_stats: Optional[dict] = None):
        self.q = q
        #: the peer address the fetch loop is draining, so errors carry
        #: the real peer
        self.current = current
        #: {"compressed", "raw", "corruptions"} charged by the reader
        self.wire_stats = wire_stats
        self.expected = 0

    def start(self, expected_batches: int) -> None:
        self.expected = expected_batches

    def batch_received(self, bid: BufferId) -> None:
        self.q.put(("batch", bid))

    def buffer_received(self, wire_bytes: int, raw_bytes: int) -> None:
        if self.wire_stats is not None:
            self.wire_stats["compressed"] += wire_bytes
            self.wire_stats["raw"] += raw_bytes

    def corruption_detected(self) -> None:
        if self.wire_stats is not None:
            self.wire_stats["corruptions"] += 1

    def transfer_error(self, message: str) -> None:
        self.q.put(("error", (self.current.get("addr"), message)))


class _StagingHandler(ShuffleReceiveHandler):
    """Holds one hedged attempt's results: first-wins hedging delivers
    EITHER the primary's batches OR the replica's, never a mix, so each
    attempt stages until it completes."""

    def __init__(self):
        self.bids: list[BufferId] = []
        self.wire = 0
        self.raw = 0
        self.corruptions = 0

    def batch_received(self, bid: BufferId) -> None:
        self.bids.append(bid)

    def buffer_received(self, wire_bytes: int, raw_bytes: int) -> None:
        self.wire += wire_bytes
        self.raw += raw_bytes

    def corruption_detected(self) -> None:
        self.corruptions += 1


class CachingShuffleReader:
    """Splits the fetch list into local blocks (catalog) and remote ones
    (transport) (reference RapidsCachingReader.read:61-100); remote
    fetches run on a fetch thread while the task consumes."""

    def __init__(self, manager: TpuShuffleManager, shuffle_id: int,
                 partition: int, task_attempt_id: int, timeout: float,
                 metrics=None):
        self.manager = manager
        self.shuffle_id = shuffle_id
        self.partition = partition
        self.task_attempt_id = task_attempt_id
        self.timeout = timeout
        self.metrics = metrics
        self.wire_stats = {"compressed": 0, "raw": 0, "corruptions": 0}
        # taken on the consuming thread, whose session conf is the
        # query's; the fetch thread installs it
        self.conf = C.get_active_conf()

    def read(self) -> Iterator[tuple[int, ColumnarBatch]]:
        from spark_rapids_tpu_torch.shuffle.recovery import PeerHealth
        health = PeerHealth.get()
        missing = MapOutputRegistry.missing_maps(self.shuffle_id)
        if missing:
            # invalidated and not yet recomputed: the survivors alone
            # would be PARTIAL data; raise the stage-retry signal
            raise FetchFailedError(
                "unregistered", None,
                f"shuffle {self.shuffle_id} is missing map outputs "
                f"{missing} (superseded by a recovery invalidation)")
        outputs = MapOutputRegistry.outputs_for(self.shuffle_id)
        hedging = bool(self.conf[C.SHUFFLE_HEDGE_ENABLED])
        local_bids: list[BufferId] = []
        # keyed (primary address, hedge replica address or None): a
        # hedged group's blocks share one replica peer
        remote: dict[tuple, list[BlockIdMsg]] = {}
        transport = self.manager.transport
        for map_id, status in sorted(outputs.items()):
            if status.partition_sizes[self.partition] == 0 and \
                    not self._has_degenerate(status, map_id):
                continue
            if status.executor_id == self.manager.executor_id:
                local_bids.extend(
                    self.manager.shuffle_catalog.blocks_for_partition(
                        self.shuffle_id, self.partition, [map_id]))
                continue
            addr = status.reachable_address(transport, health)
            hedge_addr = (status.hedge_address(transport, health)
                          if hedging else None)
            if hedge_addr == addr:
                hedge_addr = None
            remote.setdefault((addr, hedge_addr), []).append(
                BlockIdMsg(self.shuffle_id, map_id, self.partition))
        # a map that advertises data for this partition MUST deliver a
        # batch: a peer answering "no such table" (a rebuilt server whose
        # catalog never saw the shuffle) is a FetchFailed, never a
        # clean-looking empty read
        expect_nonzero = {m: s for m, s in outputs.items()
                          if s.partition_sizes[self.partition] > 0}
        delivered: set = set()
        try:
            sem = TpuSemaphore.get()
            for bid in local_bids:
                with self.manager.env.catalog.acquired(bid) as buf:
                    sem.acquire_if_necessary()
                    delivered.add(bid.map_id)
                    yield bid.map_id, buf.get_columnar_batch()
            for map_id, batch in self._fetch_remote(remote, sem):
                delivered.add(map_id)
                yield map_id, batch
            silent = sorted(set(expect_nonzero) - delivered)
            if silent:
                st = expect_nonzero[silent[0]]
                raise FetchFailedError(
                    st.reachable_address(transport, health),
                    BlockIdMsg(self.shuffle_id, silent[0], self.partition),
                    f"maps {silent} advertise data for partition "
                    f"{self.partition} but the fetch returned none "
                    f"(peer serving a catalog without this shuffle?)")
        finally:
            if self.metrics is not None:
                from spark_rapids_tpu_torch.utils import metrics as M
                if self.wire_stats["compressed"]:
                    self.metrics.add(M.SHUFFLE_COMPRESSED_BYTES,
                                     self.wire_stats["compressed"])
                    self.metrics.add(M.SHUFFLE_RAW_BYTES,
                                     self.wire_stats["raw"])
                if self.wire_stats["corruptions"]:
                    self.metrics.add(M.NUM_WIRE_CORRUPTIONS,
                                     self.wire_stats["corruptions"])
            # received buffers live for this task only
            self.manager.received_catalog.release_task(self.task_attempt_id)

    def _has_degenerate(self, status: MapStatus, map_id: int) -> bool:
        # degenerate batches report size 0 but still carry row counts; a
        # remote peer is asked, the local catalog answers cheaply
        if status.executor_id != self.manager.executor_id:
            return True
        return bool(self.manager.shuffle_catalog.blocks_for_partition(
            self.shuffle_id, self.partition, [map_id]))

    def _fetch_one(self, address: str, blocks, handler_,
                   attempt_id: int) -> None:
        """One fetch of `blocks` from `address` into `handler_` under the
        given receive-cleanup attempt id."""
        conn = self.manager.transport.make_client(address)
        client = ShuffleClient(conn, self.manager.transport,
                               self.manager.received_catalog,
                               self.manager.env.host_store, address,
                               conf=self.conf)
        try:
            client.fetch_blocks(blocks, attempt_id, handler_)
        finally:
            # a retry may have swapped in a fresh connection
            client.connection.close()

    def _fetch_remote(self, remote: dict[tuple, list[BlockIdMsg]],
                      sem) -> Iterator:
        if not remote:
            return
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.shuffle.recovery import PeerHealth
        from spark_rapids_tpu_torch.utils import watchdog as W
        health = PeerHealth.get()
        q: "queue.Queue" = queue.Queue()
        current = {"addr": next(iter(remote))[0]}
        handler = _IteratorHandler(q, current, self.wire_stats)
        errors: list[BaseException] = []
        done = threading.Event()
        # the consuming thread's query: its conf, cancellation, epoch and
        # span context reach the fetch worker (its fetch spans parent
        # under this reader's scope)
        from spark_rapids_tpu_torch.utils import profile as P
        qc = S.current()
        span_ref = P.current_ref()

        def fetch_all():
            try:
                with S.scoped(qc), C.session(self.conf), \
                        P.attach(span_ref):
                    for (address, hedge_addr), blocks in remote.items():
                        current["addr"] = address
                        if hedge_addr is not None:
                            self._hedged_group(address, hedge_addr, blocks,
                                               handler, health)
                        else:
                            self._fetch_one(address, blocks, handler,
                                            self.task_attempt_id)
                            health.record_success(address)
            except BaseException as e:  # noqa: BLE001 — raised by _consume
                errors.append(e)
                q.put(("fatal", (current.get("addr"), str(e))))
            finally:
                done.set()
                q.put(("done", None))

        def first_block(addr):
            for (a, _h), blocks in remote.items():
                if a == addr and blocks:
                    return blocks[0]
            return None

        t = threading.Thread(target=fetch_all, daemon=True,
                             name="tpu-shuffle-fetch")
        t.start()
        hb = W.heartbeat(f"shuffle-read:s{self.shuffle_id}"
                         f"p{self.partition}", kind="task", conf=self.conf)
        try:
            yield from self._consume(q, current, errors, done, first_block,
                                     hb, sem)
        finally:
            hb.close()

    def _hedged_group(self, address: str, hedge_addr: str, blocks,
                      handler, health) -> None:
        """First-wins hedged fetch of one block group (on the fetch
        thread): the primary attempt stages its results; past the hedge
        delay, or on an early primary failure, the same blocks are asked
        of the replica.  The first complete, uncorrupted attempt's
        buffers move to the reader's attempt id; the loser is cancelled
        through its AttemptToken and its staged buffers freed."""
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.shuffle.client_server import (
            hedge_delay_s)
        from spark_rapids_tpu_torch.utils import metrics as M
        from spark_rapids_tpu_torch.utils import movement as MV
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        addrs = {"primary": address, "hedge": hedge_addr}
        staging = {n: _StagingHandler() for n in addrs}
        attempt_ids = {n: next(TpuShuffleManager._attempt_ids)
                       for n in addrs}
        parent_tok = W.current_token()
        tokens = {n: W.AttemptToken(parent=parent_tok) for n in addrs}
        done = {n: threading.Event() for n in addrs}
        results: dict = {}
        threads: dict = {}
        qc = S.current()
        span_ref = P.current_ref()

        def run(name):
            try:
                with S.scoped(qc), C.session(self.conf), \
                        P.attach(span_ref), W.attempt_scope(tokens[name]):
                    self._fetch_one(addrs[name], blocks, staging[name],
                                    attempt_ids[name])
                results[name] = None
            except BaseException as e:  # noqa: BLE001 — settled below
                results[name] = e
            finally:
                done[name].set()

        def start(name):
            t = threading.Thread(target=run, args=(name,), daemon=True,
                                 name=f"tpu-shuffle-hedge-{name}")
            threads[name] = t
            t.start()

        start("primary")
        delay = hedge_delay_s(self.conf)
        deadline = time.monotonic() + delay
        while not done["primary"].is_set():
            parent_tok.check()
            left = deadline - time.monotonic()
            if left <= 0:
                break
            done["primary"].wait(min(0.02, left))
        if not (done["primary"].is_set()
                and results.get("primary") is None):
            # the primary straggles past the hedge delay (or failed):
            # race the replica for the same blocks
            if self.metrics is not None:
                self.metrics.add(M.NUM_HEDGED_FETCHES, 1)
            P.event(P.EV_HEDGE_FIRED, address=address, replica=hedge_addr,
                    blocks=len(blocks), delay_ms=round(delay * 1e3, 1))
            start("hedge")
        winner = None
        while winner is None:
            parent_tok.check()
            settled = [n for n in threads if done[n].is_set()]
            ok = [n for n in settled if results.get(n) is None]
            if ok:
                # both landed between polls: prefer the primary (the
                # payloads are identical; the tie-break keeps the hedge
                # win count meaningful)
                winner = "primary" if "primary" in ok else ok[0]
                break
            if len(settled) == len(threads):
                raise results.get("primary") or results.get("hedge")
            time.sleep(0.01)
        loser = next((n for n in threads if n != winner), None)
        if winner == "hedge" and self.metrics is not None:
            self.metrics.add(M.NUM_HEDGED_WINS, 1)
        if loser is not None:
            tokens[loser].cancel_race_lost(
                f"hedged fetch: {addrs[winner]} answered first")
        # the winner's staged buffers now belong to the reader's attempt
        st = staging[winner]
        for bid in self.manager.received_catalog.take_task(
                attempt_ids[winner]):
            self.manager.received_catalog.add_received(
                self.task_attempt_id, bid)
        if st.wire:
            handler.buffer_received(st.wire, st.raw)
        for _ in range(st.corruptions):
            handler.corruption_detected()
        for bid in st.bids:
            handler.batch_received(bid)
        health.record_success(addrs[winner])
        if loser is not None:
            # every wait of the loser is cancellable: the join is prompt
            threads[loser].join(timeout=10.0)
            if threads[loser].is_alive():
                log.warning("hedged-fetch loser (%s) did not exit after "
                            "cancellation; its buffers stay until the "
                            "shuffle is unregistered", addrs[loser])
            else:
                lst = staging[loser]
                self.manager.received_catalog.release_task(
                    attempt_ids[loser])
                # the loser's bytes crossed the wire but the query did
                # not consume them: reclassify them as wasted
                if lst.wire and MV.ledger() is not None:
                    site = ("send:loop"
                            if addrs[loser].startswith("loop://")
                            else "send:dcn")
                    MV.move(MV.EDGE_WIRE, lst.wire, site, MV.SITE_WASTED,
                            raw_bytes=lst.raw)

    def _consume(self, q, current, errors, done, first_block, hb,
                 sem) -> Iterator:
        from spark_rapids_tpu_torch.utils import watchdog as W
        finished = False
        while True:
            # poll the queue in small slices, so a cancellation is
            # honored promptly; `timeout` without a message FetchFails
            deadline = time.monotonic() + self.timeout
            while True:
                W.check_cancelled()
                try:
                    kind, payload = q.get(timeout=min(
                        0.1, max(0.0, deadline - time.monotonic())))
                    break
                except queue.Empty:
                    if time.monotonic() >= deadline:
                        addr = current.get("addr") or "remote"
                        raise FetchFailedError(
                            addr, first_block(addr),
                            f"shuffle fetch timed out after "
                            f"{self.timeout}s") from None
            if kind == "batch":
                hb.beat()
                with self.manager.env.catalog.acquired(payload) as buf:
                    sem.acquire_if_necessary()
                    yield payload.map_id, buf.get_columnar_batch()
            elif kind == "error":
                addr, msg = payload
                addr = addr or "remote"
                raise FetchFailedError(addr, first_block(addr), msg)
            elif kind == "fatal":
                addr, msg = payload
                addr = addr or "remote"
                err = errors[0] if errors else None
                if isinstance(err, FetchFailedError):
                    raise err
                if isinstance(err, (OSError, ConnectionError, EOFError)):
                    # a dead or unreachable server is a FetchFailed (a
                    # stage retry), never a raw socket error (reference
                    # RapidsShuffleIterator -> FetchFailedException)
                    raise FetchFailedError(
                        addr, first_block(addr),
                        f"shuffle server unreachable: {err}") from err
                raise err if err is not None else FetchFailedError(
                    addr, first_block(addr), msg)
            elif kind == "done":
                finished = True
            if finished and q.empty() and done.is_set():
                break
