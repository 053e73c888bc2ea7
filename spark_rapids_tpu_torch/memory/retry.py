"""OOM split-and-retry harness: the exec layer's route into the device
memory budget (port of spark_rapids_tpu/memory/retry.py; reference
parallel: `RmmRapidsRetryIterator.scala` withRetry /
withSplitAndRetry over `GpuOOM`/`SplitAndRetryOOM`, layered on
`DeviceMemoryEventHandler`'s synchronous-spill callback).

The arena is accounted (`DeviceManager.reserve`), not intercepted, as in
the reference: PyTorch's caching allocator is left alone.  Operators route each
materialization point through `with_split_retry` (splittable inputs) or
`with_retry` (single-batch contracts: window frames, join build sides):

  1. reserve the estimated output footprint before dispatching kernels;
  2. under pressure, spill the device store (`SpillCallback
     .on_alloc_pressure`) with the task's semaphore hold YIELDED so
     concurrent tasks keep the accelerator busy while this one blocks;
  3. if spilling cannot make room, raise `TpuSplitAndRetryOOM`: the
     harness halves the input `ColumnarBatch` and retries each half,
     recursing down to `spark.rapids.memory.retry.minSplitRows`;
  4. past the floor, degrade per `spark.rapids.memory.retry.fallback`:
     `bestEffort` runs the batch unreserved (the accounted arena is
     advisory — the caching allocator has the final word, and a true
     OOM surfaces as its own `torch.cuda.OutOfMemoryError`, which
     nothing here catches, as XLA's is not caught in the reference),
     `error` raises `TpuOutOfCoreError` with an actionable message.
     Never a silent wrong answer.

Deterministic OOM fault injection (`spark.rapids.memory.faultInjection
.oomRate/.seed/.maxInjections`, mirroring the transport injector in
the reference's shuffle transport injector) forces synthetic reservation
failures so the whole retry/split/fallback lattice is exercised on the CPU
without a device-sized workload.  The injector draws Python's
`random.Random(seed)` stream as the reference's does, so the same conf
fires on the same draws in both packages.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.utils import residency as RES

log = logging.getLogger(__name__)


class TpuRetryOOM(MemoryError):
    """Reservation failed but spilling made (or may make) room: retry
    the SAME input (reference `GpuRetryOOM`)."""


class TpuSplitAndRetryOOM(TpuRetryOOM):
    """Reservation failed and spilling cannot make room: the input must
    shrink before retrying (reference `GpuSplitAndRetryOOM`)."""


class TpuOutOfCoreError(MemoryError):
    """A batch already at the minimum split size still does not fit the
    accounted budget and the fallback is conf'd off."""


# ---------------------------------------------------------------------------
class OomInjector:
    """Deterministic reservation-failure injection (the memory-layer
    sibling of shuffle's transport FaultInjector).  Each fire picks the
    failure class with a second draw — half retry-class (spill should
    make room), half split-class (input must shrink) — so both harness
    lanes see traffic at any rate.  `max_injections` hard-bounds total
    fires, guaranteeing forward progress in soak loops even at rate
    1.0."""

    def __init__(self, rate: float, seed: int, max_injections: int):
        import random
        self.rate = float(rate)
        self.seed = int(seed)
        self.max_injections = int(max_injections)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected = 0

    def fire(self) -> Optional[str]:
        """None (no injection) | 'retry' | 'split'."""
        with self._lock:
            if 0 < self.max_injections <= self.injected:
                return None
            if self._rng.random() >= self.rate:
                return None
            self.injected += 1
            return "split" if self._rng.random() < 0.5 else "retry"


#: injectors keyed by (rate, seed, max): concurrent queries with
#: DIFFERENT injection confs (a soak's victim query vs its clean
#: peers) each drive their own deterministic stream instead of
#: churning one global injector's state — and a query whose conf
#: carries rate 0 never touches an injector at all, so targeted
#: injection is per-query by construction
_injectors: dict[tuple, OomInjector] = {}
_inj_lock = threading.Lock()


def _get_injector(conf) -> Optional[OomInjector]:
    rate = float(conf[C.OOM_INJECT_RATE])
    if rate <= 0:
        return None
    key = (rate, int(conf[C.OOM_INJECT_SEED]),
           int(conf[C.OOM_INJECT_MAX]))
    with _inj_lock:
        inj = _injectors.get(key)
        if inj is None:
            inj = _injectors[key] = OomInjector(*key)
        return inj


def reset_oom_injection() -> None:
    """Drop the process-global injectors so the next run re-seeds
    (tests call this between runs for determinism)."""
    with _inj_lock:
        _injectors.clear()


def injected_oom_count() -> int:
    with _inj_lock:
        return sum(i.injected for i in _injectors.values())


# ---------------------------------------------------------------------------
def estimate_batch_bytes(batch) -> int:
    """Default output-footprint estimate for a materialization over
    `batch`: the input plus one same-shaped output working copy.
    Advisory, like the rest of the accounted arena — callers with a
    better bound (join expansions, build concats) pass their own."""
    return 2 * batch.device_size_bytes()


def _device_manager(device):
    """The process's DeviceManager, made on `device` if there is none."""
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    return DeviceManager.get(device)


def _madd(metrics, name: str, value) -> None:
    if metrics is not None and value:
        metrics.add(name, value)


@contextmanager
def _sem_yielded():
    """Release the current task's semaphore hold while the body (a
    synchronous spill / memory wait) runs, so concurrent tasks make
    progress; no-op outside a task context."""
    from spark_rapids_tpu_torch.memory.semaphore import (TaskContext,
                                                         TpuSemaphore)
    ctx = TaskContext.get()
    if ctx is None:
        yield
        return
    with TpuSemaphore.get().yielded(ctx):
        yield


def _blocked_spill(dm, nbytes: int, metrics) -> None:
    """Injected-failure spill: drive the REAL SpillCallback path (so
    injection exercises the same code a true pressure event does), with
    the semaphore yielded and the wall time charged to retryBlockTime."""
    t0 = time.perf_counter_ns()
    cb = dm.spill_callback
    if cb is not None:
        cb.take_thread_freed()  # discard any stale thread residue
    with _sem_yielded(), P.span("retry-block:spill", cat=P.CAT_RETRY):
        if cb is not None:
            cb.on_alloc_pressure(nbytes, dm.budget, dm.reserved_bytes)
    if cb is not None:
        # thread-local attribution: only spills THIS thread's pressure
        # call triggered charge this exec (a concurrent query spilling
        # at the same time no longer cross-charges — the before/after
        # bytes_spilled delta did)
        _madd(metrics, M.SPILL_BYTES, cb.take_thread_freed())
    _madd(metrics, M.RETRY_BLOCK_TIME, time.perf_counter_ns() - t0)


def _blocked_reserve(dm, nbytes: int, metrics) -> bool:
    """Pressure path: `DeviceManager.reserve` spills synchronously; run
    it with the semaphore yielded.  True = room was made (reservation
    held); False = even spilling everything could not fit (reservation
    rolled back)."""
    t0 = time.perf_counter_ns()
    cb = dm.spill_callback
    if cb is not None:
        cb.take_thread_freed()
    with _sem_yielded(), P.span("retry-block:reserve", cat=P.CAT_RETRY):
        ok = dm.reserve(nbytes)
    if cb is not None:
        _madd(metrics, M.SPILL_BYTES, cb.take_thread_freed())
    _madd(metrics, M.RETRY_BLOCK_TIME, time.perf_counter_ns() - t0)
    if not ok:
        dm.release_reservation(nbytes)
    return ok


def _acquire(nbytes: int, dm, inj, metrics, escalate: bool,
             label: str = "op") -> None:
    """One reservation attempt.  Raises TpuRetryOOM (spill made room —
    try again) or TpuSplitAndRetryOOM (shrink the input).  On return the
    caller owns an `nbytes` reservation."""
    kind = inj.fire() if inj is not None else None
    if kind is not None:
        _blocked_spill(dm, nbytes, metrics)
        if kind == "split" or escalate:
            raise TpuSplitAndRetryOOM(
                f"injected reservation failure ({nbytes} bytes)")
        raise TpuRetryOOM(
            f"injected reservation failure ({nbytes} bytes)")
    if dm.try_reserve(nbytes):
        return
    if _blocked_reserve(dm, nbytes, metrics):
        # pressure resolved by spilling: count it as a retry event and
        # proceed with the reservation held (the event too, so the log's
        # oom_retry records and numRetries tell one story)
        _madd(metrics, M.NUM_RETRIES, 1)
        P.event(P.EV_OOM_RETRY, label=label, bytes=nbytes, retries=0,
                cause="pressure")
        return
    raise TpuSplitAndRetryOOM(
        f"cannot reserve {nbytes} bytes within budget {dm.budget} "
        f"(store={dm.store_bytes}, reserved={dm.reserved_bytes}) even "
        "after spilling everything spillable")


#: a single attempt unit escalates injected retry-class failures to
#: split-class after this many consecutive retries, bounding the
#: retry-in-place loop the same way the reference bounds RetryOOM
_MAX_RETRIES_PER_ATTEMPT = 2


def _run_reserved(thunk: Callable[[], object], nbytes: int, metrics,
                  label: str, device):
    """Reserve -> run -> release, looping on retry-class failures.
    Split-class failures propagate to the caller (who splits or falls
    back)."""
    dm = _device_manager(device)
    inj = _get_injector(C.get_active_conf())
    retries = 0
    while True:
        try:
            _acquire(nbytes, dm, inj, metrics,
                     escalate=retries >= _MAX_RETRIES_PER_ATTEMPT,
                     label=label)
        except TpuSplitAndRetryOOM:
            raise
        except TpuRetryOOM:
            _madd(metrics, M.NUM_RETRIES, 1)
            P.event(P.EV_OOM_RETRY, label=label, bytes=nbytes,
                    retries=retries + 1)
            retries += 1
            continue
        # residency provenance for the held reservation: the exec's
        # label names the site, so the ledger's peak composition says
        # which operator's working set drove the high-water mark
        res_token = None
        if RES.enabled():
            res_token = RES.track(
                nbytes, site=f"reserve:{label.split('[', 1)[0]}",
                tier=RES.TIER_DEVICE, kind=RES.KIND_RESERVATION)
        try:
            return thunk()
        finally:
            dm.release_reservation(nbytes)
            RES.retire(res_token)


def _floor_fallback(thunk: Callable[[], object], metrics, label: str,
                    rows) -> object:
    """Past the split floor (or for unsplittable inputs): degrade per
    conf — run unreserved, or fail with an actionable error."""
    conf = C.get_active_conf()
    mode = str(conf[C.RETRY_FALLBACK]).lower()
    if mode == "error":
        raise TpuOutOfCoreError(
            f"{label}: cannot reserve HBM for a batch (rows={rows}) even "
            f"at the minimum split size ({C.RETRY_MIN_SPLIT_ROWS.key}="
            f"{conf[C.RETRY_MIN_SPLIT_ROWS]}): the operator's working set "
            "exceeds the accounted HBM budget after spilling everything "
            "spillable.  Raise spark.rapids.memory.gpu.allocFraction, "
            "lower spark.rapids.tpu.batchMaxRows, or set "
            f"{C.RETRY_FALLBACK.key}=bestEffort to run the batch "
            "unreserved (the caching allocator then has the final word).")
    _madd(metrics, M.NUM_OOM_FALLBACKS, 1)
    P.event(P.EV_OOM_FALLBACK, label=label, rows=str(rows))
    log.warning(
        "%s: OOM retry floor reached (%s rows); running the batch "
        "unreserved (best effort) — a true device OOM will surface as "
        "torch.cuda.OutOfMemoryError", label, rows)
    return thunk()


# ---------------------------------------------------------------------------
def with_retry(body: Callable[[], object], *, out_bytes: int,
               metrics=None, label: str = "op", device=None) -> object:
    """Reserve `out_bytes`, then run `body` (reference withRetryNoSplit:
    single-batch contracts that cannot subdivide their input — window
    frames, join build-side concats, final aggregate evaluation).
    Split-class failures go straight to the floor fallback.  `device`
    is the one a DeviceManager is made on if there is none yet."""
    try:
        return _run_reserved(body, int(out_bytes), metrics, label, device)
    except TpuSplitAndRetryOOM:
        return _floor_fallback(body, metrics, label, rows="unsplittable")


def with_split_retry(batch, body: Callable[[object], object], *,
                     metrics=None, out_bytes_fn=None,
                     min_rows: Optional[int] = None,
                     label: str = "op") -> Iterator[object]:
    """Run `body` over `batch`, splitting in half and retrying the
    halves on split-class reservation failures (reference withSplitAndRetry
    over RmmRapidsRetryIterator).  Yields one body result per (possibly
    split) piece, in the input's row order.  Pieces at or below
    `min_rows` (default `spark.rapids.memory.retry.minSplitRows`) stop
    splitting and take the floor fallback."""
    conf = C.get_active_conf()
    if min_rows is None:
        min_rows = int(conf[C.RETRY_MIN_SPLIT_ROWS])
    est = out_bytes_fn or estimate_batch_bytes
    pending = [batch]
    while pending:
        b = pending.pop(0)
        try:
            yield _run_reserved(lambda: body(b), int(est(b)), metrics,
                                label, b.device)
        except TpuSplitAndRetryOOM:
            pieces = _split_in_half(b, min_rows)
            if pieces is None:
                yield _floor_fallback(lambda: body(b), metrics, label,
                                      rows=b.num_rows)
            else:
                _madd(metrics, M.NUM_SPLIT_RETRIES, 1)
                P.event(P.EV_OOM_SPLIT_RETRY, label=label,
                        rows=b.num_rows)
                pending[:0] = pieces


def _split_in_half(batch, min_rows: int):
    """Halve a batch by rows, or None at the floor.  Reads `num_rows`
    (a sync for lazy batches) — acceptable on the OOM path, which is
    already off the hot path."""
    rows = batch.num_rows
    if rows <= max(int(min_rows), 1):
        return None
    b = batch.dense()
    half = (rows + 1) // 2
    return [b.slice(0, half), b.slice(half, rows - half)]
