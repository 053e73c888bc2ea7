"""The default shuffle transport (port of
spark_rapids_tpu/shuffle/ici_transport.py; reference
`shuffle-plugin/.../ucx/UCXShuffleTransport.scala` and `UCX.scala`: UCX
tag matching with a TCP management handshake and a progress thread).

Two lanes, both by address:

  * **loopback** (`loop://<executor_id>`): an executor in this process;
    the connection drives the peer server's handlers in process.  On one
    card this is how four executors' map outputs reach a reducer.
  * **TCP** (`tcp://host:port`): a socket per peer pair with
    length-prefixed control frames and bounce-buffer-sized DATA frames,
    the role UCX tag messages play in the reference.  Each server runs
    an accept loop and a handler thread per connection, all daemon
    threads named `tpu-shuffle-*`.

Every socket has a timeout and every wait is a bounded poll, so a
closing server reclaims its threads and a reader on a dead wire gives
up; `TcpServer.close()` joins the accept loop and its handlers.  The
address travels in MapStatus, as the reference's UCX port rides in
`BlockManagerId.topologyInfo` (`RapidsShuffleInternalManager.scala:170-186`).

`FaultInjector` draws the JAX package's sequence for the same seed.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.shuffle.transport import (
    BlockIdMsg, Connection, MsgKind, ShuffleTransport, Transaction,
    TransactionStatus, WireCorruption, decode_frame, encode_control,
    encode_data, meta_response, transfer_request)

_LOOP_REGISTRY_LOCK = threading.Lock()
_LOOP_REGISTRY: dict[str, "object"] = {}  # executor_id -> request handler

#: poll slice of every blocking socket call: an accept loop or a handler
#: parked on an idle connection wakes this often to notice a close
_POLL_S = 0.25
#: a handler's budget for one send to a client that stopped reading
_SEND_TIMEOUT_S = 30.0
#: how long close() waits for the accept loop and handlers to end
_JOIN_S = 5.0


class LoopbackConnection(Connection):
    """A peer in this process: drives the server state machine directly."""

    def __init__(self, handler, transport: ShuffleTransport,
                 eid: Optional[str] = None):
        self.server = handler
        self.transport = transport
        self.eid = eid

    def _check_alive(self) -> None:
        # a killed executor leaves the registry; a held handler object
        # must not keep serving it (the socket is dead even if the
        # process is not)
        if self.eid is None:
            return
        with _LOOP_REGISTRY_LOCK:
            alive = _LOOP_REGISTRY.get(self.eid) is self.server
        if not alive:
            raise ConnectionError(f"loopback peer {self.eid} is gone")

    def request(self, frame: bytes):
        self._check_alive()
        kind, payload = decode_frame(frame[4:])
        if kind == MsgKind.METADATA_REQUEST:
            blocks = [BlockIdMsg(*b) for b in payload["blocks"]]
            metas = self.server.handle_metadata_request(blocks)
            return decode_frame(meta_response(metas)[4:])
        raise ValueError(f"unexpected request {kind}")

    def fetch(self, table_ids: Sequence[int],
              on_chunk: Callable[..., None]) -> Transaction:
        try:
            self._check_alive()
        except ConnectionError as e:
            return Transaction(TransactionStatus.ERROR, str(e))
        faults = getattr(self.server.transport, "faults", None)
        if faults is not None and faults.kill_after_frames > 0:
            server_transport = self.server.transport

            def counted(tid, seq, chunk, is_last, codec_id=-1, raw_len=0):
                if faults.note_frame():
                    # the serving executor dies mid-stream: both its
                    # lanes go dark, not just this transfer
                    server_transport.kill_self()
                    raise _InjectedDrop()
                on_chunk(tid, seq, chunk, is_last, codec_id, raw_len)

            return self.server.send_state(table_ids, counted, wire=False)
        # in-process fetch: the bytes never reach a wire, so no codec
        return self.server.send_state(table_ids, on_chunk, wire=False)


class FaultInjector:
    """Seeded wire-fault injection (the reference builds UCX with
    --enable-fault-injection): `drop` aborts a transfer mid-stream, so
    the client must drop partials, reconnect and retry; `corrupt` flips a
    byte of a DATA frame's payload, which the frame's crc32 must catch;
    `peer_kill` takes the whole peer down after kill_after_frames DATA
    frames: sockets close mid-stream, the accept loop stops and the
    loopback registration goes, so retries cannot succeed and stage
    recovery must recompute the lost map outputs.  Rates come from the
    faultInjection.* keys; 0 injects nothing."""

    def __init__(self, drop_rate: float, corrupt_rate: float,
                 seed: int, kill_after_frames: int = 0):
        self.drop_rate = float(drop_rate)
        self.corrupt_rate = float(corrupt_rate)
        self.kill_after_frames = int(kill_after_frames)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected_drops = 0
        self.injected_corruptions = 0
        self.frames_served = 0
        self.peer_killed = False

    @property
    def active(self) -> bool:
        return self.drop_rate > 0 or self.corrupt_rate > 0 \
            or self.kill_after_frames > 0

    def note_frame(self) -> bool:
        """Count one served DATA frame; True once the peer_kill budget is
        spent, and forever after (a dead peer stays dead)."""
        with self._lock:
            if self.kill_after_frames <= 0:
                return False
            if self.peer_killed:
                return True
            self.frames_served += 1
            if self.frames_served >= self.kill_after_frames:
                self.peer_killed = True
                return True
        return False

    def maybe_drop(self) -> bool:
        with self._lock:
            if self._rng.random() < self.drop_rate:
                self.injected_drops += 1
                return True
        return False

    def maybe_corrupt_frame(self, frame: bytes, payload_off: int) -> bytes:
        """Flip a byte in the PAYLOAD of an encoded frame, after its crc32
        was computed, as real wire damage would."""
        with self._lock:
            if len(frame) > payload_off and \
                    self._rng.random() < self.corrupt_rate:
                self.injected_corruptions += 1
                i = self._rng.randrange(payload_off, len(frame))
                return frame[:i] + bytes([frame[i] ^ 0xFF]) + frame[i + 1:]
        return frame


class _InjectedDrop(Exception):
    pass


class TcpServer:
    """Accept loop and a handler thread per connection (the reference's
    UCX progress thread and management port in one socket)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 faults: Optional[FaultInjector] = None,
                 on_kill: Optional[Callable[[], None]] = None):
        self.faults = faults
        self.on_kill = on_kill
        self.server = server
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._sock.settimeout(_POLL_S)
        self.address = f"tcp://{host}:{self._sock.getsockname()[1]}"
        self._closing = False
        self._handlers: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="tpu-shuffle-server",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="tpu-shuffle-handler", daemon=True)
            with self._lock:
                self._handlers = [h for h in self._handlers
                                  if h.is_alive()] + [t]
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                frame = _recv_frame(conn, alive=lambda: not self._closing)
                if frame is None:
                    return
                # serving: a send may take long, but not forever
                conn.settimeout(_SEND_TIMEOUT_S)
                if self.faults is not None and self.faults.peer_killed:
                    # a killed peer stops answering: no polite error
                    # frame, the client sees a dead wire
                    return
                kind, payload = decode_frame(frame)
                if kind == MsgKind.METADATA_REQUEST:
                    blocks = [BlockIdMsg(*b) for b in payload["blocks"]]
                    metas = self.server.handle_metadata_request(blocks)
                    _send_all(conn, meta_response(metas))
                elif kind == MsgKind.TRANSFER_REQUEST:
                    txn = self.server.send_state(
                        payload["table_ids"], self._emitter(conn))
                    _send_all(conn, _txn_frame(txn))
                else:
                    return
        except OSError:
            return
        finally:
            conn.close()

    def _emitter(self, conn: socket.socket):
        faults = self.faults

        def emit(tid, seq, chunk, is_last, codec_id=-1, raw_len=0):
            frame = encode_data(tid, (seq << 1) | int(is_last), chunk,
                                codec_id, raw_len)
            if faults is not None and faults.active:
                if faults.note_frame():
                    # peer_kill: the whole executor goes dark mid-stream
                    conn.close()
                    if self.on_kill is not None:
                        self.on_kill()
                    raise _InjectedDrop()
                if faults.maybe_drop():
                    # connection loss: a dead wire, not an error frame
                    conn.close()
                    raise _InjectedDrop()
                # the payload starts after the 4-byte length prefix and
                # the 26-byte DATA header
                frame = faults.maybe_corrupt_frame(frame, 30)
            _send_all(conn, frame)
        return emit

    def close(self) -> None:
        self._closing = True
        try:
            # wakes the accept loop at once, then frees the port
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(_JOIN_S)
        with self._lock:
            handlers = list(self._handlers)
        for h in handlers:
            if h is not threading.current_thread():
                h.join(_JOIN_S)


def _txn_frame(txn: Transaction) -> bytes:
    return encode_control(MsgKind.TRANSFER_RESPONSE, {
        "status": txn.status.value, "error": txn.error,
        "bytes": txn.bytes_transferred})


def _send_all(conn: socket.socket, data: bytes) -> None:
    conn.sendall(data)


def _recv_frame(conn: socket.socket, alive=None) -> Optional[bytes]:
    hdr = _recv_exact(conn, 4, alive)
    if hdr is None:
        return None
    (length,) = struct.unpack("<I", hdr)
    return _recv_exact(conn, length, alive)


def _recv_exact(conn: socket.socket, n: int,
                alive=None) -> Optional[bytes]:
    """Exactly `n` bytes.  With `alive` the read is a bounded poll: each
    timeout slice re-checks alive(), so a closing server reclaims its
    handlers instead of leaving them parked on idle connections."""
    if alive is not None:
        conn.settimeout(_POLL_S)
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except socket.timeout:
            if alive is not None and not alive():
                return None
            continue
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class TcpConnection(Connection):
    """Client end of the TCP lane: one exchange at a time, every read a
    bounded poll that honors cancellation and gives up after `timeout`
    seconds without data."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._read_timeout = timeout
        self._sock.settimeout(_POLL_S)
        self._lock = threading.Lock()

    def _recv_exact(self, n: int) -> Optional[bytes]:
        from spark_rapids_tpu_torch.utils import watchdog as W
        buf = bytearray()
        deadline = time.monotonic() + self._read_timeout
        while len(buf) < n:
            W.check_cancelled()
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"no data from peer for "
                        f"{self._read_timeout:.0f}s") from None
                continue
            if not chunk:
                return None
            buf += chunk
            deadline = time.monotonic() + self._read_timeout
        return bytes(buf)

    def _recv_frame(self) -> Optional[bytes]:
        hdr = self._recv_exact(4)
        if hdr is None:
            return None
        (length,) = struct.unpack("<I", hdr)
        return self._recv_exact(length)

    def request(self, frame: bytes):
        with self._lock:
            self._sock.settimeout(self._read_timeout)
            try:
                _send_all(self._sock, frame)
            finally:
                self._sock.settimeout(_POLL_S)
            resp = self._recv_frame()
            if resp is None:
                raise ConnectionError("peer closed during request")
            return decode_frame(resp)

    def fetch(self, table_ids: Sequence[int],
              on_chunk: Callable[..., None]) -> Transaction:
        with self._lock:
            try:
                self._sock.settimeout(self._read_timeout)
                try:
                    _send_all(self._sock, transfer_request(table_ids))
                finally:
                    self._sock.settimeout(_POLL_S)
                while True:
                    frame = self._recv_frame()
                    if frame is None:
                        return Transaction(TransactionStatus.ERROR,
                                           "peer closed during transfer")
                    kind, payload = decode_frame(frame)
                    if kind == MsgKind.DATA:
                        tid, packed, chunk, codec_id, raw_len = payload
                        on_chunk(tid, packed >> 1, chunk, bool(packed & 1),
                                 codec_id, raw_len)
                    elif kind == MsgKind.TRANSFER_RESPONSE:
                        return Transaction(
                            TransactionStatus(payload["status"]),
                            payload.get("error"), payload.get("bytes", 0))
                    else:
                        return Transaction(TransactionStatus.ERROR,
                                           f"unexpected frame {kind}")
            except WireCorruption as e:
                return Transaction(TransactionStatus.ERROR, str(e),
                                   corrupt=True)
            except OSError as e:
                return Transaction(TransactionStatus.ERROR, str(e))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _ServerHandle:
    """What make_server returns: the executor's two addresses."""

    def __init__(self, loop_address: str, tcp_address: str):
        self.loop_address = loop_address
        self.tcp_address = tcp_address


class IciShuffleTransport(ShuffleTransport):
    """The default transport: loopback for peers in this process, TCP for
    the rest."""

    def __init__(self, conf: C.RapidsConf):
        super().__init__(conf)
        self._servers: list[TcpServer] = []
        self._executor_ids: list[str] = []
        self.faults = FaultInjector(
            conf[C.SHUFFLE_FAULT_DROP_RATE],
            conf[C.SHUFFLE_FAULT_CORRUPT_RATE],
            conf[C.SHUFFLE_FAULT_SEED],
            conf[C.SHUFFLE_FAULT_PEER_KILL_FRAMES])

    def make_server(self, executor_id: str, request_handler):
        with _LOOP_REGISTRY_LOCK:
            _LOOP_REGISTRY[executor_id] = request_handler
        self._executor_ids.append(executor_id)
        tcp = TcpServer(request_handler,
                        faults=self.faults if self.faults.active else None,
                        on_kill=self.kill_self)
        self._servers.append(tcp)
        return _ServerHandle(f"loop://{executor_id}", tcp.address)

    def kill_self(self) -> None:
        """peer_kill's landing point: this transport's executors go dark
        on BOTH lanes (TCP listeners close, loopback registrations go),
        so no retry against them can succeed."""
        self.faults.peer_killed = True
        for s in self._servers:
            s.close()
        with _LOOP_REGISTRY_LOCK:
            for eid in self._executor_ids:
                _LOOP_REGISTRY.pop(eid, None)

    def can_reach(self, address: str) -> bool:
        # loop:// resolves only in the process that registered it; a
        # reader in another process falls back to the MapStatus's wire
        # address
        if address.startswith("loop://"):
            with _LOOP_REGISTRY_LOCK:
                return address[len("loop://"):] in _LOOP_REGISTRY
        return True

    def make_client(self, peer_address: str) -> Connection:
        if peer_address.startswith("loop://"):
            eid = peer_address[len("loop://"):]
            with _LOOP_REGISTRY_LOCK:
                handler = _LOOP_REGISTRY.get(eid)
            if handler is None:
                raise ConnectionError(f"no loopback peer {eid}")
            return LoopbackConnection(handler, self, eid=eid)
        if peer_address.startswith("tcp://"):
            host, port = peer_address[len("tcp://"):].rsplit(":", 1)
            return TcpConnection(host, int(port))
        raise ValueError(f"bad peer address {peer_address}")

    def shutdown(self) -> None:
        for s in self._servers:
            s.close()
        self._servers.clear()
        with _LOOP_REGISTRY_LOCK:
            for eid in self._executor_ids:
                _LOOP_REGISTRY.pop(eid, None)
        self._executor_ids.clear()
