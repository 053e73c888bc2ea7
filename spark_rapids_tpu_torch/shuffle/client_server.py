"""Shuffle client/server protocol state machines, transport-agnostic (port
of spark_rapids_tpu/shuffle/client_server.py; reference
`RapidsShuffleClient.scala`: metadata request/response, transfer
requests, `BufferReceiveState` chunk assembly, retry; and
`RapidsShuffleServer.scala`: `handleMetadataRequest:284`,
`BufferSendState:380`, which acquires a buffer from any tier, stages it
through send bounce buffers and is throttled).

These classes hold no sockets: the Connection and request-handler SPI
inject the wire, so the protocol is tested with mocked transports as the
reference's suites are.

Device buffers and threads: a map task writes its slices on its query's
CUDA stream, and the server serializes them on a transport thread that
may be on another stream or none.  The writer records a CUDA event with
each buffer (`ready_event`, shuffle/manager.py); `acquire_buffer_bytes`
makes the serving thread's stream wait on it, on the buffer's device,
before the copy to the host.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.memory.buffer import BufferId
from spark_rapids_tpu_torch.shuffle.catalog import (
    ShuffleBufferCatalog, ShuffleReceivedBufferCatalog)
from spark_rapids_tpu_torch.shuffle.transport import (
    BlockIdMsg, Connection, InflightLimiter, MsgKind, ShuffleTransport,
    TableMetaMsg, Transaction, TransactionStatus, meta_request,
    parse_meta_response)

log = logging.getLogger("spark_rapids_tpu_torch.shuffle")


class FetchFailedError(Exception):
    """Spark's FetchFailedException: the recovery driver
    (shuffle/recovery.py) invalidates the failed peer's map outputs and
    recomputes them.  `address` is the peer that failed and `block`, when
    known, pins the shuffle and map ids."""

    def __init__(self, address: str, block: Optional[BlockIdMsg],
                 message: str):
        super().__init__(f"fetch failed from {address} ({block}): {message}")
        self.address = address
        self.block = block

    @property
    def shuffle_id(self) -> Optional[int]:
        return self.block.shuffle_id if self.block is not None else None

    @property
    def map_id(self) -> Optional[int]:
        return self.block.map_id if self.block is not None else None


def _cancellable_backoff_sleep(seconds: float) -> None:
    """Default retry sleep: a bounded poll with a cancel-token check, so a
    backoff never outlives a cancelled query."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    W.cancellable_sleep(seconds)


#: injectable, so tests can capture the retry sleeps
_backoff_sleep = _cancellable_backoff_sleep

#: fetches in flight, named in the watchdog's dump so a timed-out query
#: says which peer and blocks it waited on
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT: dict[int, dict] = {}
_INFLIGHT_IDS = iter(range(1, 1 << 62))


def inflight_fetches() -> list[dict]:
    """Fetches in flight now: address, block ids, attempt, and seconds
    in flight."""
    now = time.monotonic()
    with _INFLIGHT_LOCK:
        snaps = [dict(v) for v in _INFLIGHT.values()]
    for f in snaps:
        f["in_flight_s"] = round(now - f.pop("_t0"), 2)
    return snaps


def inflight_count() -> int:
    with _INFLIGHT_LOCK:
        return len(_INFLIGHT)


# ---------------------------------------------------------------------------
# fetch-latency tracking for hedged reads: completed fetch durations set
# the hedge trigger's quantile, floored by shuffle.hedge.delayMs
_LATENCY_LOCK = threading.Lock()
_LATENCY_SAMPLES: "list[float]" = []
_LATENCY_MAX_SAMPLES = 256
_HEDGE_MIN_SAMPLES = 8


def note_fetch_duration(seconds: float) -> None:
    with _LATENCY_LOCK:
        _LATENCY_SAMPLES.append(float(seconds))
        if len(_LATENCY_SAMPLES) > _LATENCY_MAX_SAMPLES:
            del _LATENCY_SAMPLES[:len(_LATENCY_SAMPLES)
                                 - _LATENCY_MAX_SAMPLES]


def reset_fetch_latency() -> None:
    with _LATENCY_LOCK:
        _LATENCY_SAMPLES.clear()


def hedge_delay_s(conf: Optional[C.RapidsConf] = None) -> float:
    """How long a fetch may be outstanding before a hedge fires:
    max(hedge.delayMs, the hedge.quantile of recent fetch durations) once
    enough samples exist, else the delayMs floor alone."""
    conf = conf or C.get_active_conf()
    floor = float(conf[C.SHUFFLE_HEDGE_DELAY_MS]) / 1e3
    q = min(1.0, max(0.0, float(conf[C.SHUFFLE_HEDGE_QUANTILE])))
    with _LATENCY_LOCK:
        if len(_LATENCY_SAMPLES) < _HEDGE_MIN_SAMPLES:
            return floor
        ordered = sorted(_LATENCY_SAMPLES)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return max(floor, ordered[idx])


class ShuffleReceiveHandler:
    """Callback surface the reader implements (reference
    RapidsShuffleFetchHandler): batchReceived / transferError."""

    def start(self, expected_batches: int) -> None:
        ...

    def batch_received(self, bid: BufferId) -> None:
        ...

    def buffer_received(self, wire_bytes: int, raw_bytes: int) -> None:
        """One assembled payload landed: its wire (compressed) and
        uncompressed sizes."""
        ...

    def corruption_detected(self) -> None:
        """A DATA frame failed its CRC and the transfer will retry."""
        ...

    def transfer_error(self, message: str) -> None:
        ...


class BufferReceiveState:
    """Assembles DATA chunks into whole serialized batches and returns
    the in-flight budget as each lands in the host store (reference
    BufferReceiveState, RapidsShuffleClient.scala:108)."""

    def __init__(self, metas: Sequence[TableMetaMsg],
                 received_catalog: ShuffleReceivedBufferCatalog,
                 host_store, task_attempt_id: int,
                 limiter: InflightLimiter,
                 handler: ShuffleReceiveHandler,
                 progress: Optional[Callable[[], None]] = None):
        self.metas = {m.table_id: m for m in metas}
        self.received_catalog = received_catalog
        self.host_store = host_store
        self.task_attempt_id = task_attempt_id
        self.limiter = limiter
        self.handler = handler
        self.progress = progress
        self.completed: set[int] = set()
        self._chunks: dict[int, list[bytes]] = {}
        self._lock = threading.Lock()

    def on_chunk(self, table_id: int, seq: int, chunk: bytes,
                 is_last: bool, codec_id: int = -1,
                 raw_len: int = 0) -> None:
        if self.progress is not None:
            self.progress()  # a chunk landed: the fetch is alive
        with self._lock:
            parts = self._chunks.setdefault(table_id, [])
            assert seq == len(parts), (
                f"out-of-order chunk {seq} for table {table_id}")
            parts.append(chunk)
            if not is_last:
                return
            blob = b"".join(self._chunks.pop(table_id))
            self.completed.add(table_id)
        wire_len = len(blob)
        if codec_id != -1:
            # the server compressed the payload for the wire
            from spark_rapids_tpu_torch.shuffle.compression import get_codec
            blob = get_codec(codec_id).decompress(blob, raw_len)
        # movement ledger, receive side: mirrors the sender's record, so
        # bytes served == bytes assembled is checkable in one process;
        # 'recv' sites are left out of edge totals
        from spark_rapids_tpu_torch.utils import movement as MV
        MV.record(MV.EDGE_WIRE, wire_len, site="recv", raw_bytes=len(blob))
        self.handler.buffer_received(wire_len, len(blob))
        meta_msg = self.metas[table_id]
        bid = BufferId(self.received_catalog.new_buffer_id().table_id,
                       meta_msg.shuffle_id, meta_msg.map_id,
                       meta_msg.partition)
        # provenance: received buffers land in the host tier under a
        # reduce-side site, apart from the sender's map buffers
        from spark_rapids_tpu_torch.utils import residency as RES
        with RES.site_scope("shuffle-recv"):
            self.host_store.add_blob(bid, blob, meta_msg.table_meta())
        self.received_catalog.add_received(self.task_attempt_id, bid)
        self.limiter.release(meta_msg.size_bytes)  # mirrors the acquire
        self.handler.batch_received(bid)

    def drop_partial(self, table_id: int) -> None:
        with self._lock:
            self._chunks.pop(table_id, None)


class ShuffleClient:
    """Per-peer fetch driver (reference RapidsShuffleClient), in two
    phases: a metadata round trip, then transfers with bounded in-flight
    bytes and bounded retries on transport errors (FetchRetry:406),
    spaced by exponential backoff with seeded jitter."""

    def __init__(self, connection: Connection, transport: ShuffleTransport,
                 received_catalog: ShuffleReceivedBufferCatalog,
                 host_store, address: str = "peer",
                 conf: Optional[C.RapidsConf] = None):
        self.connection = connection
        self.transport = transport
        self.received_catalog = received_catalog
        self.host_store = host_store
        self.address = address
        conf = conf or C.get_active_conf()
        self.conf = conf
        self.max_retries = int(conf[C.SHUFFLE_FETCH_MAX_RETRIES])
        self._backoff_base = \
            float(conf[C.SHUFFLE_FETCH_BACKOFF_BASE_MS]) / 1000.0
        self._backoff_cap = \
            float(conf[C.SHUFFLE_FETCH_BACKOFF_CAP_MS]) / 1000.0
        self._seed = int(conf[C.SHUFFLE_FAULT_SEED])
        #: the backoff's jitter, seeded (deterministic retry schedules in
        #: tests) and made at the first retry: a fetch that never
        #: retries, nearly every one, seeds nothing
        self._rng: Optional[random.Random] = None

    def _backoff(self, attempt: int) -> float:
        if self._rng is None:
            self._rng = random.Random(self._seed if self._seed else None)
        delay = min(self._backoff_cap,
                    self._backoff_base * (2 ** max(0, attempt - 1)))
        delay *= 0.5 + 0.5 * self._rng.random()
        if delay > 0:
            _backoff_sleep(delay)
        return delay

    def fetch_blocks(self, blocks: Sequence[BlockIdMsg],
                     task_attempt_id: int,
                     handler: ShuffleReceiveHandler) -> list[TableMetaMsg]:
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        fid = next(_INFLIGHT_IDS)
        with _INFLIGHT_LOCK:
            _INFLIGHT[fid] = {
                "address": self.address, "attempt": 0,
                "blocks": [str(b) for b in blocks[:8]],
                "_t0": time.monotonic()}
        with W.heartbeat(f"shuffle-fetch:{self.address}", kind="task",
                         conf=self.conf) as hb, \
                P.span(f"shuffle-fetch:{self.address}", cat=P.CAT_SHUFFLE):
            t0 = time.monotonic()
            try:
                out = self._fetch_blocks(blocks, task_attempt_id, handler,
                                         hb, fid)
                # completed fetches feed the hedge trigger's quantile
                note_fetch_duration(time.monotonic() - t0)
                return out
            finally:
                with _INFLIGHT_LOCK:
                    _INFLIGHT.pop(fid, None)

    def _fetch_blocks(self, blocks, task_attempt_id, handler, hb, fid
                      ) -> list[TableMetaMsg]:
        from spark_rapids_tpu_torch.memory.buffer import DegenerateBuffer
        from spark_rapids_tpu_torch.utils import watchdog as W
        kind, payload = self.connection.request(meta_request(blocks))
        if kind != MsgKind.METADATA_RESPONSE:
            raise FetchFailedError(self.address, blocks[0] if blocks else
                                   None, f"unexpected response {kind}")
        metas = parse_meta_response(payload)
        real = [m for m in metas if not m.is_degenerate]
        handler.start(len(metas))
        # degenerate (rows-only) batches need no data phase: they become
        # metadata-only buffers on the receive side too
        for m in metas:
            if not m.is_degenerate:
                continue
            bid = BufferId(self.received_catalog.new_buffer_id().table_id,
                           m.shuffle_id, m.map_id, m.partition)
            self.received_catalog.catalog.register(
                DegenerateBuffer(bid, m.table_meta(), self.host_store.device))
            self.received_catalog.add_received(task_attempt_id, bid)
            handler.batch_received(bid)
        if not real:
            return metas
        limiter = self.transport.receive_limiter
        state = BufferReceiveState(real, self.received_catalog,
                                   self.host_store, task_attempt_id,
                                   limiter, handler, progress=hb.beat)
        pending = list(real)
        attempt = 0
        while pending:
            # a round boundary is a cancellation point: a cancelled query
            # issues no fresh transfer request
            W.check_cancelled()
            with _INFLIGHT_LOCK:
                if fid in _INFLIGHT:
                    _INFLIGHT[fid]["attempt"] = attempt
            batch_ids, budget_taken = [], []
            for m in pending:
                if not limiter.acquire(m.size_bytes,
                                       timeout=None if not batch_ids
                                       else 0.0):
                    break  # send what we have; the rest in the next round
                batch_ids.append(m.table_id)
                budget_taken.append(m)
            txn = self.connection.fetch(batch_ids, state.on_chunk)
            if txn.status == TransactionStatus.SUCCESS:
                pending = [m for m in pending
                           if m.table_id not in state.completed]
                continue
            from spark_rapids_tpu_torch.utils import profile as P
            if txn.corrupt:
                # detected wire damage is first-class: metered on the
                # exchange and correlated in the event log
                handler.corruption_detected()
                P.event(P.EV_WIRE_CORRUPTION, address=self.address,
                        error=str(txn.error)[:200])
            # return the budget of the buffers that did not complete
            for m in budget_taken:
                if m.table_id not in state.completed:
                    state.drop_partial(m.table_id)
                    limiter.release(m.size_bytes)
            pending = [m for m in pending
                       if m.table_id not in state.completed]
            attempt += 1
            if attempt > self.max_retries:
                handler.transfer_error(txn.error or "transfer failed")
                P.event(P.EV_FETCH_FAILURE, address=self.address,
                        attempts=attempt, error=str(txn.error)[:200])
                raise FetchFailedError(
                    self.address, blocks[0] if blocks else None,
                    f"transfer failed after {attempt} attempts: "
                    f"{txn.error}")
            log.warning("shuffle fetch retry %d from %s: %s", attempt,
                        self.address, txn.error)
            P.event(P.EV_FETCH_RETRY, address=self.address,
                    attempt=attempt, error=str(txn.error)[:200])
            self._backoff(attempt)
            # a mid-stream abort leaves the socket dead on the server
            # side: reconnect before retrying (the reference re-registers
            # the UCX endpoint on a failed Transaction)
            try:
                fresh = self.transport.make_client(self.address)
            except Exception:  # noqa: BLE001 — the retry reports it
                fresh = None
            if fresh is not None:
                try:
                    self.connection.close()
                except Exception:  # noqa: BLE001
                    pass
                self.connection = fresh
        return metas


class ShuffleServer:
    """Serves metadata and data for this executor's shuffle buffers
    (reference RapidsShuffleServer).  `send_state` slices each serialized
    buffer into bounce-buffer-sized chunks; a buffer is acquired from
    whatever tier holds it (device or spilled)."""

    def __init__(self, shuffle_catalog: ShuffleBufferCatalog,
                 transport: ShuffleTransport, codec=None,
                 executor_id: Optional[str] = None):
        self.shuffle_catalog = shuffle_catalog
        self.transport = transport
        #: payload codec on the wire (spark.rapids.shuffle.compression.codec)
        self.codec = codec
        #: owning executor, so the slow injector can target one server
        self.executor_id = executor_id

    def handle_metadata_request(self, blocks: Sequence[BlockIdMsg]
                                ) -> list[TableMetaMsg]:
        out = []
        for b in blocks:
            for bid in self.shuffle_catalog.blocks_for_partition(
                    b.shuffle_id, b.partition, map_ids=[b.map_id]):
                out.append(TableMetaMsg.of(
                    bid, self.shuffle_catalog.meta_for(bid)))
        return out

    def acquire_buffer_bytes(self, table_id: int) -> bytes:
        """A catalog buffer serialized for the wire, whichever tier holds
        it (reference BufferSendState acquires from the catalog, :380).
        A device buffer is copied after its writer's stream reached it."""
        catalog = self.shuffle_catalog.catalog
        bid = self.shuffle_catalog.lookup_table(table_id)
        with catalog.acquired(bid) as buf:
            ev = getattr(buf, "ready_event", None)
            if ev is None:
                return buf.get_host_bytes()
            import torch
            with torch.cuda.device(buf.ready_device):
                torch.cuda.current_stream().wait_event(ev)
                return buf.get_host_bytes()

    def send_state(self, table_ids: Sequence[int],
                   emit: Callable[..., None],
                   wire: bool = True) -> Transaction:
        """Stream the requested buffers as bounce-buffer-sized chunks.
        With a synchronous `emit` the chunks are slices of the payload;
        the send bounce pool sizes them.  `wire=False` (loopback fetches)
        skips the codec: the bytes never leave the process."""
        from spark_rapids_tpu_torch.utils import watchdog as W
        total = 0
        chunk_size = self.transport.send_bounce.buffer_size
        codec = self.codec if wire else None
        # handlers run on transport threads with no session conf; the
        # transport's own conf carries the watchdog and injection keys
        wconf = getattr(self.transport, "conf", None)
        from spark_rapids_tpu_torch.shuffle.compression import (
            note_compression)
        from spark_rapids_tpu_torch.utils import movement as MV
        from spark_rapids_tpu_torch.utils import profile as P
        wire_site = "send:dcn" if wire else "send:loop"
        try:
            # a handler runs on a transport thread with no captured span
            # context: its span parents under the query root, which still
            # names the thread and its timeline in the Chrome trace
            with W.heartbeat("shuffle-server", kind="task",
                             conf=wconf) as hb, \
                    P.span("shuffle-server", cat=P.CAT_SHUFFLE):
                for tid in table_ids:
                    t0 = time.perf_counter_ns()
                    blob = self.acquire_buffer_bytes(tid)
                    raw_len = len(blob)
                    codec_id = -1
                    if codec is not None:
                        blob = codec.compress(blob)
                        codec_id = codec.codec_id
                        note_compression(codec.name, raw_len, len(blob))
                    n = len(blob)
                    nchunks = max(1, -(-n // chunk_size))
                    for i in range(nchunks):
                        # a handler wedged between chunks is the server
                        # stall the heartbeat names and hangSite fakes
                        W.maybe_hang("shuffle-server", conf=wconf)
                        chunk = blob[i * chunk_size:(i + 1) * chunk_size]
                        emit(tid, i, chunk, i == nchunks - 1, codec_id,
                             raw_len)
                        hb.beat()
                        total += len(chunk)
                    # movement ledger: one wire record per served buffer,
                    # the payload and its uncompressed size, timed over
                    # acquire + compress + emit.  Loopback fetches run on
                    # the client's thread, so the record lands in the
                    # fetching query's ledger; TCP handlers fall back to
                    # the newest tracer
                    MV.record(MV.EDGE_WIRE, n, site=wire_site,
                              raw_bytes=raw_len,
                              dur_ns=time.perf_counter_ns() - t0,
                              codec=codec.name if codec else "none")
                    # seeded slow-peer injection: a degraded server serves
                    # each buffer slowFactor x slower, after the buffer,
                    # so a hedged winner can land; cancellable
                    W.maybe_slow("shuffle-server", conf=wconf,
                                 executor_id=self.executor_id)
        except Exception as e:  # noqa: BLE001 — surfaces as the transaction
            return Transaction(TransactionStatus.ERROR, str(e), total)
        return Transaction(TransactionStatus.SUCCESS,
                           bytes_transferred=total)
