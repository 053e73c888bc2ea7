"""Async pipelined execution: bounded prefetch between pipeline stages
(port of spark_rapids_tpu/exec/pipeline.py).

The engine is host-driven: Python pulls batches through operator
iterators while the per-batch work runs as torch ops and CUDA kernels.
`PrefetchIterator` runs an upstream iterator on a producer thread up to
`prefetchDepth` batches ahead of its consumer through a bounded queue.

Where it runs.  The port prefetches at the file scan alone
(`io/exec.py`): there the producer waits outside the GIL (file reads,
Arrow decode, the upload), so its wait overlaps the consumer's work.
The reference also prefetches at coalesce and on both sides of the
local exchange; the port does not, because there the upstream is host
dispatch of torch ops under the GIL, which a second thread cannot
overlap and only slows: on an H100 host each producer's thread costs
time, and queries with producers at every pipeline break run slower
than without them (scripts/torch_prefetch_cost.py measures both;
PERF.md has the numbers).

Discipline:

* **Bounded depth**: the queue holds at most `prefetchDepth` batches,
  so a fast producer cannot flood device memory.
* **Semaphore**: a producer blocked on a full queue never holds the
  semaphore: its task's hold is yielded for the duration of the block.
* **Task identity**: the producer runs under the creating thread's
  `TaskContext` when one exists, else under a private one that is
  force-completed (semaphore released) when the thread ends.
* **Query and conf**: the producer runs scoped to the creator's
  `QueryContext` and cancel token with the creator's conf installed, so
  its conf reads, deferred checks, semaphore group and cancellation all
  belong to the right query.
* **CUDA stream**: the creator's device and current stream are captured
  at construction and entered by the producer, so every launch and
  allocation of the upstream work is ordered on the consumer's stream
  and batches cross the queue without a sync between streams.
* **Errors and cancellation**: a producer exception is raised again at
  the consumer's next pull (so OOM split-and-retry and deopt recovery
  act on the consuming side as they would synchronously); `close()`
  cancels the producer, drains the queue, closes the source iterator
  and joins the thread.
* **Lazy start**: the producer starts on the first pull, not at plan
  build: the scan's `execute_partitions()` makes every partition's
  iterator at once.
* **Query end**: the query closes every iterator it made when it ends
  (`QueryContext.close_producers`), so a consumer that stopped early (a
  limit) leaves no producer parked on a full queue.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from contextlib import nullcontext
from typing import Iterable, Iterator, Optional

from spark_rapids_tpu_torch.utils import metrics as M

log = logging.getLogger("spark_rapids_tpu_torch.pipeline")

#: end-of-stream sentinel (errors ride on `self._error`, set before it)
_DONE = object()

#: task ids of producers made outside any task; far above real task ids
_PRODUCER_TASK_IDS = itertools.count(1 << 40)

#: poll granularity of cancellable queue waits
_POLL_S = 0.05

#: how long close() waits for a producer thread before declaring it
#: leaked (module-level so tests can shrink it)
_JOIN_TIMEOUT_S = 10.0

_STATS_LOCK = threading.Lock()
#: cumulative counters; `max_in_flight` is the most batches queued at
#: once across all producers, `leaked_producers` the threads that
#: outlived close()'s join
_STATS = {"producers": 0, "hits": 0, "stalls": 0, "wait_ns": 0,
          "blocked_puts": 0, "leaked_producers": 0, "max_in_flight": 0}
#: live occupancy: running producer threads, batches queued now,
#: consumers blocked on an empty queue and producers parked on a full one
_LIVE_STATS = {"producers": 0, "in_flight": 0, "stalled_consumers": 0,
               "blocked_producers": 0}


def pipeline_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def pipeline_live() -> dict:
    with _STATS_LOCK:
        return dict(_LIVE_STATS)


def reset_pipeline_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(name: str, value: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[name] += value


def _bump_live(name: str, delta: int) -> None:
    with _STATS_LOCK:
        _LIVE_STATS[name] += delta
        if name == "in_flight" and \
                _LIVE_STATS["in_flight"] > _STATS["max_in_flight"]:
            _STATS["max_in_flight"] = _LIVE_STATS["in_flight"]


def _cuda_stream_of_caller():
    """(device index, stream) current on this thread, or None where CUDA
    is not in use yet (a CPU run never touches it)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    idx = torch.cuda.current_device()
    return idx, torch.cuda.current_stream(idx)


class PrefetchIterator:
    """Depth-bounded background prefetch over a batch iterator.

    Iterator protocol on the consumer side; the source runs on a producer
    thread started at the first pull.  `close()` (also called by GC)
    cancels the producer, drains the queue and closes the source."""

    def __init__(self, source: Iterable, depth: int,
                 label: str = "pipeline", metrics=None, conf=None):
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.memory.semaphore import TaskContext
        from spark_rapids_tpu_torch.utils import checks as CK
        from spark_rapids_tpu_torch.utils import watchdog as W
        assert depth > 0
        self._source = iter(source)
        self._q: "queue.Queue" = queue.Queue(maxsize=int(depth))
        self._label = label
        self._metrics = metrics
        self._conf = conf if conf is not None else C.get_active_conf()
        #: the creator's task identity, shared with the producer
        self._ctx = TaskContext.get()
        #: the deopt-retry flag (iterators are rebuilt per attempt, so
        #: capture at construction is exact)
        self._retrying = CK.is_retrying()
        self._qc = S.current()
        if self._qc is not None:
            # closed at the query's end whatever its consumer did
            with self._qc._lock:
                self._qc.producers.add(self)
        self._token = W.current_token()
        #: the creator's span context (None unless its query is
        #: profiled): the producer thread attaches here, so its spans
        #: parent under the pipeline break that started it
        from spark_rapids_tpu_torch.utils import profile as P
        self._span_ref = P.current_ref()
        self._stream = _cuda_stream_of_caller()
        self._hb = None
        self._closed = threading.Event()
        #: test-facing: set while the producer is parked on a full queue
        #: (the window in which it must not hold the semaphore)
        self.blocked = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._done = False

    # -- consumer side ------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        self._ensure_started()
        try:
            item = self._q.get_nowait()
            _bump("hits")
            if self._metrics is not None:
                self._metrics.add(M.PREFETCH_HITS, 1)
        except queue.Empty:
            item = self._wait_for_item()
        if item is _DONE:
            self._done = True
            self._finish()
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        _bump_live("in_flight", -1)
        return item

    def _wait_for_item(self):
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        t0 = time.perf_counter_ns()
        # a stalled pull is the overlap loss the profile's breakdown
        # names (a no-op unprofiled)
        sp = P.span(f"pipeline-wait:{self._label}", cat=P.CAT_WAIT) \
            if P.tracer() is not None else P._NULL_SPAN
        _bump_live("stalled_consumers", 1)
        try:
            # the wait is the producer's to answer for: a consumer that
            # is itself a watched producer pauses its own heartbeat
            with sp, W.waiting_on_other():
                return self._poll_queue()
        finally:
            _bump_live("stalled_consumers", -1)
            waited = time.perf_counter_ns() - t0
            _bump("stalls")
            _bump("wait_ns", waited)
            if self._metrics is not None:
                self._metrics.add(M.PREFETCH_STALLS, 1)
                self._metrics.add(M.PIPELINE_WAIT_TIME, waited)

    def _poll_queue(self):
        while True:
            try:
                return self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if self._token.cancelled:
                    # release what the producer buffered before
                    # surfacing, so the failed query pins nothing
                    self.close()
                    self._token.check()
                t = self._thread
                if t is None or not t.is_alive():
                    # producer exited: drain the put/exit race, then
                    # end of stream (the caller checks the error)
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        return _DONE

    def _drain(self) -> None:
        try:
            while True:
                if self._q.get_nowait() is not _DONE:
                    _bump_live("in_flight", -1)
        except queue.Empty:
            pass

    def close(self) -> None:
        """Cancel the producer and release everything it buffered."""
        self._done = True
        self._closed.set()
        self._drain()
        self._join_or_leak()
        # a put that raced the first drain
        self._drain()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _finish(self) -> None:
        self._join_or_leak()

    def _join_or_leak(self) -> None:
        """Join the producer; a thread that outlives the bounded join is
        counted as leaked and its stack logged, never silently dropped."""
        t = self._thread
        if (t is None or not t.is_alive()
                or t is threading.current_thread()):
            return
        t.join(timeout=_JOIN_TIMEOUT_S)
        if not t.is_alive():
            return
        self._thread = None  # joining again later cannot succeed
        _bump("leaked_producers")
        from spark_rapids_tpu_torch.utils import watchdog as W
        log.warning(
            "prefetch producer %s survived the %.0fs close() join and "
            "was leaked (source iterator is wedged); stack:\n%s",
            t.name, _JOIN_TIMEOUT_S,
            W.thread_stack(t.ident) or "<unavailable>")

    # -- producer side ------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, daemon=True,
                name=f"tpu-prefetch-{self._label}")
            _bump("producers")
            _bump_live("producers", 1)
            self._thread.start()

    def _stream_scope(self):
        if self._stream is None:
            return nullcontext()
        import torch
        idx, stream = self._stream
        torch.cuda.set_device(idx)
        return torch.cuda.stream(stream)

    def _produce(self) -> None:
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.memory.semaphore import TaskContext
        from spark_rapids_tpu_torch.utils import checks as CK
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        if self._retrying:
            CK.set_retrying(True)
        own_ctx = None
        if self._ctx is not None:
            TaskContext.set_current(self._ctx)
        else:
            own_ctx = TaskContext(next(_PRODUCER_TASK_IDS))
            TaskContext.set_current(own_ctx)
        # thread the query's token and context through the TaskContext
        # so this thread's checks (and its own helpers') reach the query
        cur = TaskContext.get()
        if getattr(cur, "cancel_token", None) is None:
            cur.cancel_token = self._token
        if getattr(cur, "query_ctx", None) is None:
            cur.query_ctx = self._qc
        try:
            with S.scoped(self._qc), C.session(self._conf), \
                    self._stream_scope(), P.attach(self._span_ref), \
                    P.span(f"producer:{self._label}", cat=P.CAT_PIPELINE):
                hb = W.heartbeat(f"producer:{self._label}", kind="task",
                                 details=lambda: f"queue depth "
                                 f"{self._q.qsize()}/{self._q.maxsize}")
                self._hb = hb
                try:
                    with hb, W.watching(hb):
                        for item in self._source:
                            hb.beat()
                            W.maybe_hang("producer")
                            if not self._put(item):
                                return  # consumer closed
                except BaseException as e:  # noqa: BLE001 — raised again
                    self._error = e         # at the consumer's pull
                self._put(_DONE)
        finally:
            self._hb = None
            try:
                close = getattr(self._source, "close", None)
                if close is not None:
                    close()
            except Exception:
                pass
            if own_ctx is not None:
                # private task identity: release any semaphore hold the
                # source's device work took
                own_ctx.complete()
            TaskContext.set_current(None)
            _bump_live("producers", -1)

    def _put(self, item) -> bool:
        """Enqueue with backpressure.  False = consumer cancelled.  A
        producer parked on a full queue yields its semaphore hold."""
        counted = item is not _DONE
        if counted:
            _bump_live("in_flight", 1)
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            pass
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        _bump("blocked_puts")
        _bump_live("blocked_producers", 1)
        self.blocked.set()
        hb = self._hb
        try:
            # parked on a full queue: the consumer's stall, not ours;
            # pause the heartbeat so backpressure never reads as a hang,
            # and watch the token so a cancelled query's producer exits
            with TpuSemaphore.get().yielded(), \
                    (hb.pause() if hb is not None else nullcontext()):
                while not self._closed.is_set():
                    if self._token.cancelled:
                        break
                    try:
                        self._q.put(item, timeout=_POLL_S)
                        return True
                    except queue.Full:
                        continue
            if counted:
                _bump_live("in_flight", -1)
            return False
        finally:
            _bump_live("blocked_producers", -1)
            self.blocked.clear()


def maybe_prefetch(source: Iterable, label: str = "pipeline",
                   metrics=None, conf=None,
                   depth: Optional[int] = None) -> Iterator:
    """Wrap `source` in a PrefetchIterator when the session conf enables
    pipelining (and `depth`/prefetchDepth > 0); otherwise return it
    unwrapped.  Call at iterator-construction time on the thread that
    carries the session conf."""
    from spark_rapids_tpu_torch import config as C
    conf = conf if conf is not None else C.get_active_conf()
    if not conf[C.PIPELINE_ENABLED]:
        return iter(source)
    if depth is None:
        depth = int(conf[C.PIPELINE_PREFETCH_DEPTH])
    if depth <= 0:
        return iter(source)
    return PrefetchIterator(source, depth, label=label, metrics=metrics,
                            conf=conf)
