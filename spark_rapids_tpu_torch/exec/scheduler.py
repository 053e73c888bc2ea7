"""Concurrent multi-query serving: query contexts, admission control and
the plan-fingerprint result cache (port of spark_rapids_tpu/exec/
scheduler.py).

* **QueryContext**: one per top-level query: the query id, the conf
  SNAPSHOT, the `CancelToken`, the per-query watchdog stats, the
  per-query deferred-check registry, and the execution epoch and collect
  depth of `CommonSubplanExec` caches.  Installed thread-locally on the
  query's thread and carried by `TaskContext.query_ctx` and `scoped()` to
  every helper thread (prefetch producers, AQE stage fills), so a fault
  in query A cancels, retries or fails A alone.
* **QueryScheduler**: admission control against the `DeviceManager`
  admission ledger: a query declares a device-memory budget
  (`spark.rapids.sql.scheduler.queryBudgetBytes`, by default an equal
  share of the accounted budget) and is admitted only while the sum of
  admitted budgets fits and fewer than `maxConcurrentQueries` queries
  are in flight.  Otherwise it queues FIFO (bounded by `queueDepth`,
  watched by a task-class heartbeat) and is shed with a descriptive
  `TpuQueryRejected` when the queue is full or `queueTimeout` passes.
* **ResultCache**: a byte-bounded LRU keyed by (plan structural
  fingerprint, source-data identity, session-conf fingerprint): a hit
  returns the cached pandas result (copied, bit-exact) without touching
  the device.  A plan with a leaf the fingerprinter does not know is not
  cached.

`CollectScope` is the collect-side handshake (`TpuExec.collect`): the
outermost collect on a thread with no live QueryContext creates one,
admits it, and serializes on the PLAN INSTANCE lock (two sessions
sharing one plan object would race its CommonSubplanExec caches and
metrics; distinct plan instances run concurrently).

Observability: a query's profile (utils/profile.py) begins in
`QueryScope` BEFORE admission, so queue wait is a span of the query's
own breakdown; admission decisions are events of its log; telemetry and
kernel attribution start lazily on the first query whose conf enables
them (utils/telemetry.py, utils/kernelprof.py), and the in-flight query
count feeds the telemetry sampler.

`whole_mesh_dispatch` is the whole-mesh gate of the mesh lanes (an SPMD
gang, a mesh exchange round): one such step holds every slot of the
active mesh, so the gate serializes them process-wide.
"""
from __future__ import annotations

import collections
import datetime
import decimal
import enum
import itertools
import logging
import os
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Optional

import numpy as np

from spark_rapids_tpu_torch import config as C

log = logging.getLogger("spark_rapids_tpu_torch.scheduler")


class TpuQueryRejected(RuntimeError):
    """Admission control shed this query: the device is saturated and the
    wait queue is full (or the queue deadline passed)."""


# ---------------------------------------------------------------------------
# execution epochs: minted process-globally so no two query attempts can
# collide on a CommonSubplanExec cache tag, scoped per query so one
# query's attempt never invalidates another's caches
_EPOCH_COUNTER = itertools.count(1)
_EPOCH_LOCK = threading.Lock()
_LAST_EPOCH = 0

_QUERY_IDS = itertools.count(1)


def new_epoch() -> int:
    global _LAST_EPOCH
    with _EPOCH_LOCK:
        _LAST_EPOCH = next(_EPOCH_COUNTER)
        return _LAST_EPOCH


def current_epoch() -> int:
    """The epoch `CommonSubplanExec` caches are scoped to: the current
    query's attempt epoch, or (no query in flight: a direct
    execute_partitions) the last minted value."""
    qc = current()
    if qc is not None and qc.epoch:
        return qc.epoch
    return _LAST_EPOCH


# ---------------------------------------------------------------------------
class QueryContext:
    """Everything one in-flight query owns."""

    __slots__ = ("query_id", "conf", "token", "stats", "pending_checks",
                 "tracer", "epoch", "budget_bytes", "admitted", "dm",
                 "producers", "device", "report_plan", "_depth", "_lock")

    def __init__(self, conf: Optional[C.RapidsConf] = None):
        from spark_rapids_tpu_torch.utils import watchdog as W
        self.query_id = f"q{next(_QUERY_IDS):06d}-{os.getpid() & 0xffff}"
        self.conf = conf if conf is not None else C.get_active_conf()
        self.token = W.CancelToken()
        #: per-query watchdog counters: query A's trip never charges B
        self.stats = {"timeouts": 0, "cancels": 0, "dumps": 0,
                      "slowest_heartbeat_ms": 0}
        #: per-query deferred-check registry (utils/checks.py)
        self.pending_checks: list = []
        self.tracer = None           # utils/profile.QueryTracer or None
        self.epoch = 0               # minted per top-level attempt
        self.budget_bytes = 0        # declared admission budget
        self.admitted = False        # holds an admission-ledger slot
        self.dm = None               # the DeviceManager it was admitted on
        #: the query's prefetch iterators (exec/pipeline.py), closed when
        #: the query ends: a consumer that stopped early (a limit) would
        #: otherwise leave its producer parked on a full queue, holding
        #: device batches
        self.producers = weakref.WeakSet()
        #: the device the query's plan runs on (None: not known), which
        #: decides how its spans annotate (utils/tracing.py)
        self.device = None
        self.report_plan = None      # outermost plan, for the profile
        self._depth = 0              # collect() nesting within this query
        self._lock = threading.Lock()

    def close_producers(self) -> None:
        """Close every prefetch iterator of this query (each drains its
        queue and joins its producer)."""
        with self._lock:
            its = list(self.producers)
            self.producers = weakref.WeakSet()
        for it in its:
            it.close()

    def enter_collect(self) -> bool:
        with self._lock:
            self._depth += 1
            return self._depth == 1

    def exit_collect(self) -> bool:
        with self._lock:
            self._depth -= 1
            return self._depth == 0

    @property
    def collect_depth(self) -> int:
        with self._lock:
            return self._depth


_TLS = threading.local()


def current() -> Optional[QueryContext]:
    """The calling thread's QueryContext: the thread-locally installed
    one, else the one riding the thread's TaskContext."""
    qc = getattr(_TLS, "qc", None)
    if qc is not None:
        return qc
    from spark_rapids_tpu_torch.memory.semaphore import TaskContext
    ctx = TaskContext.get()
    if ctx is not None:
        return getattr(ctx, "query_ctx", None)
    return None


@contextmanager
def scoped(qc: Optional[QueryContext]):
    """Install `qc` as this thread's QueryContext for the duration
    (helper threads capture their creator's `current()` and enter this).
    None is a no-op."""
    if qc is None:
        yield None
        return
    prev = getattr(_TLS, "qc", None)
    _TLS.qc = qc
    try:
        yield qc
    finally:
        _TLS.qc = prev


# ---------------------------------------------------------------------------
class _QueueEntry:
    __slots__ = ("qc", "budget", "max_queries", "enqueued", "admitted")

    def __init__(self, qc: QueryContext, budget: int, max_queries: int):
        self.qc = qc
        self.budget = budget
        self.max_queries = max_queries
        self.enqueued = time.monotonic()
        self.admitted = False


def _device_manager(device):
    """The process's DeviceManager, made on `device` if there is none
    yet; None for a plan with no device part and no manager."""
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    dm = DeviceManager.peek()
    if dm is None and device is not None:
        dm = DeviceManager.get(device)
    return dm


class QueryScheduler:
    """Process singleton gatekeeper in front of query execution."""

    _instance: Optional["QueryScheduler"] = None
    _ilock = threading.Lock()

    def __init__(self):
        self._cv = threading.Condition()
        self._queue: list[_QueueEntry] = []   # FIFO
        self._stats = {"admitted": 0, "queued": 0, "rejected": 0,
                       "queue_timeouts": 0, "max_queue_depth": 0,
                       "longest_queue_wait_ms": 0, "max_admitted": 0}

    @classmethod
    def get(cls) -> "QueryScheduler":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._ilock:
            cls._instance = None

    # -----------------------------------------------------------------------
    @staticmethod
    def _budget_for(conf: C.RapidsConf, dm) -> int:
        declared = int(conf[C.SCHED_QUERY_BUDGET])
        if declared > 0:
            return declared
        maxq = max(1, int(conf[C.SCHED_MAX_CONCURRENT]))
        return max(1, dm.budget // maxq)

    def admit(self, qc: QueryContext, conf: C.RapidsConf,
              device=None) -> bool:
        """Admit `qc` (True) or queue until admissible; raises
        `TpuQueryRejected` when the queue is full or the queue deadline
        passes, and `TpuQueryTimeout` if the query is cancelled while
        queued.  False = scheduler disabled, or a plan with no device
        part before any DeviceManager exists (nothing to admit on)."""
        if not conf[C.SCHED_ENABLED]:
            return False
        dm = _device_manager(device)
        if dm is None:
            return False
        from spark_rapids_tpu_torch.utils import profile as P
        budget = self._budget_for(conf, dm)
        maxq = max(1, int(conf[C.SCHED_MAX_CONCURRENT]))
        qc.budget_bytes = budget
        with self._cv:
            if self._try_admit_locked(qc, budget, maxq, dm):
                P.event(P.EV_QUERY_ADMITTED, query=qc.query_id,
                        budget_bytes=budget, queued_ms=0)
                return True
            depth = int(conf[C.SCHED_QUEUE_DEPTH])
            if len(self._queue) >= max(0, depth):
                self._stats["rejected"] += 1
                snap = self._snapshot_locked(dm)
                P.event(P.EV_QUERY_REJECTED, query=qc.query_id,
                        budget_bytes=budget, **snap)
                raise TpuQueryRejected(
                    f"query {qc.query_id} rejected: admission queue is "
                    f"full ({len(self._queue)}/{depth} waiting, "
                    f"{snap['admitted_queries']} queries admitted "
                    f"holding {snap['admitted_bytes']}/{dm.budget} "
                    f"budget bytes).  Retry later, raise "
                    f"{C.SCHED_QUEUE_DEPTH.key}, or lower "
                    f"{C.SCHED_QUERY_BUDGET.key} "
                    f"(requested {budget} bytes).")
            entry = _QueueEntry(qc, budget, maxq)
            self._queue.append(entry)
            self._stats["queued"] += 1
            self._stats["max_queue_depth"] = max(
                self._stats["max_queue_depth"], len(self._queue))
            P.event(P.EV_QUERY_QUEUED, query=qc.query_id,
                    budget_bytes=budget, position=len(self._queue))
        return self._wait_admitted(entry, conf, dm)

    def _wait_admitted(self, entry: _QueueEntry, conf: C.RapidsConf,
                       dm) -> bool:
        """Park in the admission queue: bounded polls so cancellation is
        honored, a task-class heartbeat that beats as the queue drains,
        and the explicit `queueTimeout` bound."""
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        qc = entry.qc
        timeout = float(conf[C.SCHED_QUEUE_TIMEOUT])
        deadline = entry.enqueued + timeout
        last_pos = None
        hb = W.heartbeat(f"query-queue:{qc.query_id}", kind="task",
                         conf=conf, details=lambda: self.describe())
        try:
            with P.span(f"admission-queue:{qc.query_id}",
                        cat=P.CAT_QUEUE), self._cv:
                while True:
                    if entry.admitted:
                        waited = (time.monotonic() - entry.enqueued) * 1e3
                        self._stats["longest_queue_wait_ms"] = max(
                            self._stats["longest_queue_wait_ms"],
                            int(waited))
                        P.event(P.EV_QUERY_ADMITTED, query=qc.query_id,
                                budget_bytes=entry.budget,
                                queued_ms=int(waited))
                        return True
                    try:
                        pos = self._queue.index(entry) + 1
                    except ValueError:
                        pos = 0
                    if pos != last_pos:
                        hb.beat()      # queue progress, not a hang
                        last_pos = pos
                    now = time.monotonic()
                    if qc.token.cancelled or now >= deadline:
                        self._remove_locked(entry)
                        if qc.token.cancelled:
                            qc.token.check()  # raises TpuQueryTimeout
                        self._stats["queue_timeouts"] += 1
                        self._stats["rejected"] += 1
                        snap = self._snapshot_locked(dm)
                        P.event(P.EV_QUERY_REJECTED, query=qc.query_id,
                                budget_bytes=entry.budget,
                                timeout_s=timeout, **snap)
                        raise TpuQueryRejected(
                            f"query {qc.query_id} rejected: spent "
                            f"{timeout:.1f}s ({C.SCHED_QUEUE_TIMEOUT.key})"
                            f" in the admission queue at position {pos} "
                            f"({snap['admitted_queries']} queries "
                            f"admitted holding "
                            f"{snap['admitted_bytes']}/{dm.budget} "
                            "budget bytes).")
                    self._cv.wait(min(0.05, max(0.0, deadline - now)))
        finally:
            hb.close()
            with self._cv:
                self._remove_locked(entry)

    def _try_admit_locked(self, qc: QueryContext, budget: int,
                          maxq: int, dm) -> bool:
        n = len(dm.admissions())
        if n >= maxq:
            return False
        if not dm.try_admit(qc.query_id, budget):
            return False
        qc.admitted = True
        qc.dm = dm
        self._stats["admitted"] += 1
        self._stats["max_admitted"] = max(self._stats["max_admitted"], n + 1)
        return True

    def _remove_locked(self, entry: _QueueEntry) -> None:
        try:
            self._queue.remove(entry)
        except ValueError:
            pass

    def release(self, qc: QueryContext) -> None:
        """Return `qc`'s admission slot and drain the queue head(s)."""
        if not qc.admitted:
            return
        dm = qc.dm
        with self._cv:
            dm.release_admission(qc.query_id)
            qc.admitted = False
            qc.dm = None
            # FIFO drain: admit from the head while it fits; stopping at
            # the first entry that does not keeps arrival order
            for entry in list(self._queue):
                if entry.admitted:
                    continue
                if not self._try_admit_locked(entry.qc, entry.budget,
                                              entry.max_queries, dm):
                    break
                entry.admitted = True
            self._cv.notify_all()

    # -----------------------------------------------------------------------
    def _snapshot_locked(self, dm) -> dict:
        adm = dm.admissions()
        return {"admitted_queries": len(adm),
                "admitted_bytes": sum(adm.values()),
                "queue_depth": len(self._queue)}

    def stats(self) -> dict:
        with self._cv:
            return dict(self._stats)

    def reset_stats(self) -> None:
        with self._cv:
            for k in self._stats:
                self._stats[k] = 0

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def describe(self) -> str:
        """One-line admission state for watchdog dumps and heartbeats."""
        from spark_rapids_tpu_torch.memory.device_manager import \
            DeviceManager
        try:
            dm = DeviceManager.peek()
            with self._cv:
                adm = dm.admissions() if dm is not None else {}
                queued = [(e.qc.query_id, e.budget) for e in self._queue]
            budget = dm.budget if dm is not None else 0
            return (f"admitted={adm} admitted_bytes="
                    f"{sum(adm.values())}/{budget} queued={queued}")
        except Exception as e:  # noqa: BLE001 — diagnostics only
            return f"<unavailable: {e}>"


# ---------------------------------------------------------------------------
class QueryScope:
    """Query ownership for a user-facing entry point: if the calling
    thread has no live QueryContext, creates one, begins its profile
    (BEFORE admission, so queue wait is a first-class span/category in
    the query's own breakdown) and admits it (on the DeviceManager of
    `device`); otherwise a no-op that defers to the enclosing scope.
    `plan/overrides.collect` holds one around the whole drive (deopt
    retries, the AQE stage loop, partly accelerated plans) and
    `TpuExec.collect` holds one per direct collect."""

    __slots__ = ("qc", "owns", "prof_owner", "_prev_tls")

    def __init__(self, conf: Optional[C.RapidsConf] = None, device=None):
        from spark_rapids_tpu_torch.utils import kernelprof as KP
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import telemetry as T
        self.qc = current()
        self.owns = self.qc is None
        self.prof_owner = None
        self._prev_tls = None
        if not self.owns:
            return
        conf = conf if conf is not None else C.get_active_conf()
        self.qc = QueryContext(conf)
        self.qc.device = device
        self._prev_tls = getattr(_TLS, "qc", None)
        _TLS.qc = self.qc
        # engine-wide telemetry: lazy-started on the first collect whose
        # conf enables it; the in-flight query count feeds the
        # utilization sampler's idle/host attribution
        T.maybe_start(conf)
        T.note_query_begin()
        # kernel attribution: the same lazy, sticky start
        KP.maybe_enable(conf)
        try:
            self.prof_owner = P.begin_query(conf)
            QueryScheduler.get().admit(self.qc, conf, device)
        except BaseException as e:
            self.close(error=e)
            raise

    def close(self, error: Optional[BaseException] = None,
              end_profile: bool = True) -> None:
        """Close the query's producers, assemble its profile (unless the
        caller already did: TpuExec.collect orders it after its metrics
        charge) and release its admission and the thread-local
        installation (owner only)."""
        if not self.owns:
            return
        self.owns = False
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import telemetry as T
        try:
            self.qc.close_producers()
            # the query's unresolved checks died with it: free their flags
            self.qc.pending_checks.clear()
            if end_profile:
                P.end_query(self.prof_owner, self.qc.report_plan,
                            error=error)
        finally:
            try:
                QueryScheduler.get().release(self.qc)
            finally:
                T.note_query_end()
                _TLS.qc = self._prev_tls


class CollectScope:
    """The per-collect handshake `TpuExec.collect` drives.  Not a context
    manager: collect needs the outermost flag and the profile owner
    between its own finally steps."""

    __slots__ = ("plan", "qc", "owns_qc", "prof_owner", "outermost",
                 "_qscope", "_plan_locked")

    def __init__(self, plan):
        self.plan = plan
        self._qscope = QueryScope(device=_plan_device(plan))
        self.qc = self._qscope.qc
        self.owns_qc = self._qscope.owns
        self.prof_owner = self._qscope.prof_owner
        self._plan_locked = False
        entered = False
        try:
            self.outermost = self.qc.enter_collect()
            entered = True
            if self.outermost:
                # serialize collects over the SAME plan instance: its
                # CommonSubplanExec caches and metrics are instance state
                self._lock_plan()
                if self.qc.report_plan is None:
                    self.qc.report_plan = plan
        except BaseException as e:
            if entered:
                # a cancelled plan-lock wait must not leave the depth
                # bumped
                self.qc.exit_collect()
            self._qscope.close(error=e)
            raise

    def _lock_plan(self) -> None:
        lock = getattr(self.plan, "_plan_lock", None)
        if lock is None:
            return
        while not lock.acquire(timeout=0.1):
            self.qc.token.check()
        self._plan_locked = True

    def finish_collect(self) -> bool:
        """Decrement the query's collect depth; True = this was the
        outermost collect (the caller releases plan state and assembles
        the profile before `close`)."""
        return self.qc.exit_collect()

    def close(self) -> None:
        """Release the plan lock and, for the qc owner, the admission slot
        and the thread-local installation (the profile was ended by
        collect itself, ordered after the metrics charge)."""
        if self._plan_locked:
            self.plan._plan_lock.release()
            self._plan_locked = False
        self._qscope.close(end_profile=False)


# ---------------------------------------------------------------------------
# the whole-mesh dispatch gate (exec/spmd.py gangs, shuffle/exchange.py's
# mesh rounds)
#
# Task-level sharing of a device is the TpuSemaphore's job and per-query
# memory admission the ledger's, but a whole-mesh step (a gang, an
# exchange round) occupies every slot of the mesh at once.  In the
# reference two threads enqueueing such programs could invert the queue
# order on two devices and deadlock their rendezvous; the port's steps
# copy between the slots' devices, so the gate keeps the same rule: one
# whole-mesh step at a time, process-wide.  The wait is a bounded poll
# that honours the calling query's CancelToken; reentrant, so a lane that
# composes steps (the count and data phases) holds it across both.

_MESH_GATE = threading.RLock()
_MESH_GATE_STATS = {"dispatches": 0, "longest_wait_ms": 0}
_MESH_GATE_STATS_LOCK = threading.Lock()


@contextmanager
def whole_mesh_dispatch(label: str = "spmd"):
    """Hold the process-wide whole-mesh slot for one mesh step."""
    from spark_rapids_tpu_torch.utils import watchdog as W
    t0 = time.monotonic()
    while not _MESH_GATE.acquire(timeout=0.05):
        W.check_cancelled()
    waited_ms = int((time.monotonic() - t0) * 1e3)
    with _MESH_GATE_STATS_LOCK:
        _MESH_GATE_STATS["dispatches"] += 1
        _MESH_GATE_STATS["longest_wait_ms"] = max(
            _MESH_GATE_STATS["longest_wait_ms"], waited_ms)
    try:
        yield
    finally:
        _MESH_GATE.release()


def mesh_gate_stats() -> dict:
    with _MESH_GATE_STATS_LOCK:
        return dict(_MESH_GATE_STATS)


def _plan_device(plan):
    """The device a plan runs on, or None where it cannot say."""
    try:
        return plan.device()
    except Exception:  # noqa: BLE001 — a leafless helper plan
        return None


# ---------------------------------------------------------------------------
# plan-fingerprint result cache
class _CacheKey:
    """Equality = structural fingerprint + conf fingerprint + IDENTITY of
    the source data objects.  Holding strong refs to the sources pins
    their ids for the entry's lifetime."""

    __slots__ = ("structure", "conf_fp", "sources", "_hash")

    def __init__(self, structure: str, conf_fp: tuple, sources: tuple):
        self.structure = structure
        self.conf_fp = conf_fp
        self.sources = sources
        self._hash = hash((structure, conf_fp,
                           tuple(id(s) for s in sources)))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, _CacheKey)
                and self.structure == other.structure
                and self.conf_fp == other.conf_fp
                and len(self.sources) == len(other.sources)
                and all(a is b for a, b in zip(self.sources,
                                               other.sources)))


#: attributes that hold an exec's run-time state or links, not what it
#: computes
_SKIP_ATTRS = frozenset({"_children", "metrics", "exec_id", "_plan_lock",
                         "_session_conf", "_session_device", "_meta",
                         "_cached", "_epoch"})


class _Unkeyable(Exception):
    """A plan value the fingerprint cannot key exactly: the plan is not
    cached rather than keyed by less than all it computes."""


#: values keyed by their type and repr
_SCALARS = (bool, int, float, complex, str, bytes, decimal.Decimal,
            datetime.date, datetime.time, datetime.timedelta, np.generic)


def _value_sig(v, path: tuple = ()) -> str:
    """A structural signature of one attribute value, to its leaves:
    scalars by type and value, containers element-wise, the package's
    own objects (expressions, partitionings, sort orders, fused stages)
    by class and attributes.  Raises _Unkeyable for a value it cannot
    key exactly (a foreign object such as an array, or a cycle)."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    if v is None:
        return "None"
    if isinstance(v, _SCALARS):
        return f"{type(v).__name__}:{v!r}"
    if isinstance(v, enum.Enum):
        return f"{type(v).__qualname__}.{v.name}"
    if isinstance(v, type):
        return f"class:{v.__module__}.{v.__qualname__}"
    if isinstance(v, TpuExec):
        return "<exec>"  # a child alias: children are keyed structurally
    if id(v) in path:
        raise _Unkeyable(f"a cycle through {type(v).__name__}")
    path = path + (id(v),)
    if isinstance(v, (list, tuple)):
        return (type(v).__name__ + "["
                + ",".join(_value_sig(x, path) for x in v) + "]")
    if isinstance(v, dict):
        return "{" + ",".join(f"{_value_sig(k, path)}:{_value_sig(x, path)}"
                              for k, x in v.items()) + "}"
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_value_sig(x, path) for x in v)) + "}"
    mod = getattr(type(v), "__module__", "") or ""
    attrs = getattr(v, "__dict__", None)
    if mod.startswith("spark_rapids_tpu_torch") and attrs is not None:
        return type(v).__qualname__ + "(" + ",".join(
            f"{k}={_value_sig(x, path)}"
            for k, x in sorted(attrs.items())
            if k not in _SKIP_ATTRS) + ")"
    raise _Unkeyable(f"a {mod}.{type(v).__qualname__} value")


def _node_sig(node) -> str:
    return type(node).__name__ + "(" + ",".join(
        f"{k}={_value_sig(v)}" for k, v in sorted(vars(node).items())
        if k not in _SKIP_ATTRS) + ")"


def _fingerprint_node(node, sources: list) -> Optional[str]:
    """Structural fingerprint of one plan node, collecting source-data
    identity objects into `sources`.  None = not cacheable (an
    unrecognized leaf): never guess."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource, RangeExec
    if not isinstance(node, TpuExec):
        return None
    if isinstance(node, LocalBatchSource):
        # the plan-build-stable identity (the backing pandas partitions,
        # stamped by the CpuSource converter): re-planning the same query
        # uploads fresh device batches over the same session frames
        ident = getattr(node, "source_identity", None)
        sources.extend(ident if ident is not None
                       else (b for part in node.partitions for b in part))
        return (f"LocalBatchSource({len(node.partitions)} parts,"
                f"{node.output_schema()})")
    if isinstance(node, RangeExec):
        return _node_sig(node)
    if type(node).__name__ == "TpuFileSourceScanExec":
        # file identity: path and (size, mtime), so a rewritten file
        # invalidates the entry
        try:
            stats = []
            for part in node.scan.partitions:
                for s in part.splits:
                    st = os.stat(s.path)
                    stats.append((s.path, st.st_size, st.st_mtime_ns))
            return f"{_node_sig(node)}::{sorted(set(stats))!r}"
        except Exception:  # noqa: BLE001 — unstatable source: no cache
            return None
    if node.children:
        kids = []
        for c in node.children:
            fp = _fingerprint_node(c, sources)
            if fp is None:
                return None
            kids.append(fp)
        return f"{_node_sig(node)}[{';'.join(kids)}]"
    return None  # unrecognized leaf (stage wrappers, transitions, ...)


def result_cache_key(plan, conf: C.RapidsConf) -> Optional[_CacheKey]:
    """Cache key of a fully accelerated plan under `conf`, or None when
    result caching is off or the plan is not fingerprintable."""
    if not conf[C.RESULT_CACHE_ENABLED]:
        return None
    if int(conf[C.RESULT_CACHE_MAX_BYTES]) <= 0:
        return None
    sources: list = []
    try:
        structure = _fingerprint_node(plan, sources)
    except _Unkeyable as e:
        log.debug("result cache: plan not cached: %s", e)
        return None
    except Exception:  # noqa: BLE001 — a fingerprint failure means
        return None    # "don't cache", never "fail the query"
    if structure is None:
        return None
    return _CacheKey(structure, conf.fingerprint(), tuple(sources))


class ResultCache:
    """Byte-bounded LRU of collected query results (pandas frames)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self._stats = {"hits": 0, "misses": 0, "evictions": 0, "stores": 0}

    @staticmethod
    def _df_bytes(df) -> int:
        try:
            return int(df.memory_usage(index=True, deep=True).sum())
        except Exception:  # noqa: BLE001
            return 1 << 20

    def get(self, key: _CacheKey):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._stats["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self._stats["hits"] += 1
            df, _ = hit
        # copy OUTSIDE the lock: callers may mutate the returned frame
        return df.copy(deep=True)

    def put(self, key: _CacheKey, df, max_bytes: int) -> None:
        nbytes = self._df_bytes(df)
        if nbytes > max_bytes:
            return  # larger than the whole cache
        frozen = df.copy(deep=True)
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self._bytes -= old
            self._entries[key] = (frozen, nbytes)
            self._bytes += nbytes
            self._stats["stores"] += 1
            while self._bytes > max_bytes and self._entries:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._bytes -= evicted
                self._stats["evictions"] += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {**self._stats, "entries": len(self._entries),
                    "bytes": self._bytes}


_RESULT_CACHE = ResultCache()


def result_cache() -> ResultCache:
    return _RESULT_CACHE
