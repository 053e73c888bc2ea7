"""TpuSemaphore: limits how many tasks hold the accelerator concurrently
(port of spark_rapids_tpu/memory/semaphore.py; reference
`GpuSemaphore.scala:27-161`, conf
`spark.rapids.sql.concurrentGpuTasks`).

Tasks acquire before their first device use (e.g. after host-side scan
buffering) and release when leaving the device (columnar->row, partition
slicing to host).  Acquisition is per-task refcounted — nested operators in
one task acquire once — with a task-completion hook that force-releases,
like the reference's TaskContext listener.

Grant policy (the multi-query serving layer's fair share): permits are
NOT handed out by raw wakeup race.  Each waiter is tagged with its
query (via the TaskContext's `query_ctx`); a freed permit goes first to
tasks re-acquiring after a `yielded()` spill (they keep their original
queue position — parking to spill must not cost a starving query its
turn), then to the waiting QUERY holding the fewest permits (ties
broken FIFO by arrival).  One heavy query with many ready tasks can
therefore never starve an interactive query's single task: the moment
the light query has fewer holds, its waiter is next.  `snapshot()`
exposes the holder table, per-query holds, the live waiter list, and
`longestWaitMs` so a diagnostic dump shows who is starving whom.

A task with no `query_ctx` of its own charges the thread's current query
(`exec/scheduler.py` `S.current`), else itself.  Permit waits are bounded
polls that honor the query's cancel token (utils/watchdog.py).  Not
ported: the profile's wait events.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Optional


class TaskContext:
    """Minimal task identity carrier (Spark TaskContext stand-in).

    A dynamic `query_ctx` attribute (an object with a `query_id`) names
    the query a task's permit is charged to; helper threads sharing a
    task inherit it with the context object."""

    _local = threading.local()

    def __init__(self, task_attempt_id: int):
        self.task_attempt_id = task_attempt_id
        self._completion_listeners = []

    def on_task_completion(self, fn) -> None:
        self._completion_listeners.append(fn)

    def complete(self) -> None:
        for fn in self._completion_listeners:
            fn(self)
        self._completion_listeners.clear()
        if getattr(TaskContext._local, "ctx", None) is self:
            TaskContext._local.ctx = None

    @classmethod
    def get(cls) -> Optional["TaskContext"]:
        return getattr(cls._local, "ctx", None)

    @classmethod
    def set_current(cls, ctx: Optional["TaskContext"]) -> None:
        cls._local.ctx = ctx

    def __enter__(self):
        TaskContext.set_current(self)
        return self

    def __exit__(self, *exc):
        self.complete()


class _Waiter:
    __slots__ = ("seq", "group", "reacquire", "enqueued", "thread")

    def __init__(self, seq: int, group, reacquire: bool):
        self.seq = seq
        self.group = group
        self.reacquire = reacquire
        self.enqueued = time.monotonic()
        self.thread = threading.current_thread().name


#: bounded-poll granularity for permit waits
_POLL_S = 0.05


class TpuSemaphore:
    _instance: Optional["TpuSemaphore"] = None
    _ilock = threading.Lock()

    def __init__(self, max_concurrent: int):
        assert max_concurrent > 0
        self.max_concurrent = max_concurrent
        self._permits = max_concurrent
        self._cv = threading.Condition()
        self._refs: dict[int, int] = {}
        self._holder_group: dict[int, object] = {}   # tid -> group
        self._group_holds: dict[object, int] = {}    # group -> permits
        self._waiters: list[_Waiter] = []
        self._seq = itertools.count(1)
        self._longest_wait_ms = 0
        self._wait_count = 0

    # -- fair-share bookkeeping ---------------------------------------------
    @staticmethod
    def _group_of(ctx: "TaskContext"):
        """The fair-share group a task charges its permit to: its
        query, else (driver-less/test tasks) the task itself."""
        qc = getattr(ctx, "query_ctx", None)
        if qc is None:
            from spark_rapids_tpu_torch.exec import scheduler as S
            qc = S.current()
        if qc is not None:
            return qc.query_id
        return ("task", ctx.task_attempt_id)

    def _select_next(self) -> Optional[_Waiter]:
        """The waiter the next free permit belongs to.  Re-acquirers
        (yielded around a spill) first, in their original order; then
        the query with the fewest current holds, FIFO within it."""
        if not self._waiters:
            return None
        re = [w for w in self._waiters if w.reacquire]
        if re:
            return min(re, key=lambda w: w.seq)
        return min(self._waiters,
                   key=lambda w: (self._group_holds.get(w.group, 0),
                                  w.seq))

    def _wait_for_permit(self, group, reacquire: bool = False) -> None:
        """Block (cancellably) until this waiter is granted a permit; on
        return one permit is held and charged to `group`."""
        from spark_rapids_tpu_torch.utils import watchdog as W
        token = W.current_token()
        w = _Waiter(next(self._seq), group, reacquire)
        blocked = False
        with self._cv:
            self._waiters.append(w)
            try:
                while self._permits <= 0 or self._select_next() is not w:
                    blocked = True
                    if token.cancelled:
                        token.check()   # raises TpuQueryTimeout
                    self._cv.wait(_POLL_S)
                self._permits -= 1
                self._group_holds[group] = \
                    self._group_holds.get(group, 0) + 1
            finally:
                self._waiters.remove(w)
                # our departure may change _select_next for the rest
                self._cv.notify_all()
            if blocked:
                waited_ms = int((time.monotonic() - w.enqueued) * 1e3)
                self._wait_count += 1
                if waited_ms > self._longest_wait_ms:
                    self._longest_wait_ms = waited_ms
        if blocked:
            from spark_rapids_tpu_torch.utils import profile as P
            P.event(P.EV_SEMAPHORE_WAIT, group=str(group),
                    wait_ms=waited_ms, reacquire=reacquire)

    def _return_permit(self, group) -> None:
        with self._cv:
            self._permits += 1
            n = self._group_holds.get(group, 0) - 1
            if n > 0:
                self._group_holds[group] = n
            else:
                self._group_holds.pop(group, None)
            self._cv.notify_all()

    # -- singleton (executor-lifetime) --------------------------------------
    @classmethod
    def initialize(cls, max_concurrent: int) -> "TpuSemaphore":
        with cls._ilock:
            cls._instance = cls(max_concurrent)
            return cls._instance

    @classmethod
    def get(cls) -> "TpuSemaphore":
        with cls._ilock:
            if cls._instance is None:
                cls._instance = cls(1)
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._ilock:
            cls._instance = None

    # -----------------------------------------------------------------------
    def acquire_if_necessary(self, ctx: Optional[TaskContext] = None) -> None:
        ctx = ctx or TaskContext.get()
        if ctx is None:
            return  # non-task context (driver-side): no admission control
        tid = ctx.task_attempt_id
        group = self._group_of(ctx)
        with self._cv:
            if self._refs.get(tid, 0) > 0:
                self._refs[tid] += 1
                return
        self._wait_for_permit(group)
        with self._cv:
            if self._refs.get(tid, 0) > 0:
                # two threads of ONE task (a pipeline producer + its
                # consumer) raced the first acquire: a task holds at
                # most one permit, so give the extra one back
                self._refs[tid] += 1
                self._permits += 1
                n = self._group_holds.get(group, 0) - 1
                if n > 0:
                    self._group_holds[group] = n
                else:
                    self._group_holds.pop(group, None)
                self._cv.notify_all()
                return
            first = tid not in self._refs
            self._refs[tid] = 1
            self._holder_group[tid] = group
        if first:
            ctx.on_task_completion(lambda c: self.release_all(c))

    def release_if_necessary(self, ctx: Optional[TaskContext] = None) -> None:
        ctx = ctx or TaskContext.get()
        if ctx is None:
            return
        tid = ctx.task_attempt_id
        with self._cv:
            n = self._refs.get(tid, 0)
            if n == 0:
                return
            if n > 1:
                self._refs[tid] = n - 1
                return
            del self._refs[tid]
            group = self._holder_group.pop(tid, None)
        self._return_permit(group)

    def release_all(self, ctx: TaskContext) -> None:
        tid = ctx.task_attempt_id
        with self._cv:
            n = self._refs.pop(tid, 0)
            group = self._holder_group.pop(tid, None)
        if n > 0:
            self._return_permit(group)

    def holders(self) -> int:
        with self._cv:
            return len(self._refs)

    def available_permits(self) -> int:
        """Free permits right now (test/diagnostic probe)."""
        with self._cv:
            return self._permits

    def waiting_count(self) -> int:
        """Tasks currently blocked waiting for a permit (telemetry
        gauge; snapshot() renders the full who-waits-on-whom table)."""
        with self._cv:
            return len(self._waiters)

    def wait_stats(self) -> dict:
        """Blocked-acquire counters for the telemetry registry."""
        with self._cv:
            return {"longest_wait_ms": self._longest_wait_ms,
                    "wait_count": self._wait_count}

    def snapshot(self) -> dict:
        """Diagnostic copy for the watchdog dump: the per-task refcount
        table, per-query permit holds, the live waiter list (who is
        starving), and the longest blocked acquire observed
        (`longestWaitMs`) — after a cancelled query releases
        everything, `refs` must come back empty."""
        with self._cv:
            return {
                "refs": dict(self._refs),
                "queryHolds": {str(g): n
                               for g, n in self._group_holds.items()},
                "waiters": [f"{w.group}"
                            f"{'(reacquire)' if w.reacquire else ''}"
                            f"@{w.thread}"
                            f"+{(time.monotonic() - w.enqueued) * 1e3:.0f}ms"
                            for w in self._waiters],
                "longestWaitMs": self._longest_wait_ms,
                "waitCount": self._wait_count,
            }

    def holds(self, ctx: Optional[TaskContext] = None) -> int:
        """Refcount held by the given (default: current) task — 0 means
        it does not hold the accelerator.  Test-facing: the pipeline
        suite asserts a producer parked on a full prefetch queue holds
        nothing."""
        ctx = ctx or TaskContext.get()
        if ctx is None:
            return 0
        with self._cv:
            return self._refs.get(ctx.task_attempt_id, 0)

    @contextmanager
    def held(self, ctx: Optional[TaskContext] = None):
        self.acquire_if_necessary(ctx)
        try:
            yield
        finally:
            self.release_if_necessary(ctx)

    @contextmanager
    def yielded(self, ctx: Optional[TaskContext] = None):
        """Fully release this task's hold for the duration of the body
        (a synchronous spill / memory wait), restoring the same
        refcount afterwards — so concurrent tasks can use the
        accelerator while this task blocks on memory (the reference
        releases the GPU semaphore around DeviceMemoryEventHandler's
        synchronous spill for the same reason).  Re-acquisition is
        queue-position-preserving: a task parked here outranks every
        waiter that arrived after it (`_select_next` serves reacquire
        waiters first), so spilling never costs a query its turn.
        No-op outside a task context or when the task holds nothing.

        A task may run on several threads (a prefetch producer shares its
        creator's task): if another thread of the task took a permit
        again while this one was yielded, the task already holds one, and
        this thread adds its refcount to it instead of waiting for a
        second permit (which the task's own hold would block forever)."""
        ctx = ctx or TaskContext.get()
        if ctx is None:
            yield
            return
        tid = ctx.task_attempt_id
        with self._cv:
            n = self._refs.pop(tid, 0)
            group = self._holder_group.pop(tid, None)
        if n > 0:
            self._return_permit(group)
        try:
            yield
        finally:
            if n > 0 and not self._rejoin(tid, n):
                self._wait_for_permit(group, reacquire=True)
                with self._cv:
                    if self._refs.get(tid, 0) > 0:
                        # a sibling thread re-took the task's permit while
                        # this one waited: give the second one back
                        self._refs[tid] += n
                        self._permits += 1
                        left = self._group_holds.get(group, 0) - 1
                        if left > 0:
                            self._group_holds[group] = left
                        else:
                            self._group_holds.pop(group, None)
                        self._cv.notify_all()
                    else:
                        self._refs[tid] = n
                        self._holder_group[tid] = group

    def _rejoin(self, tid: int, n: int) -> bool:
        """Add `n` to task `tid`'s refcount if the task holds a permit
        already (taken by another of its threads); False if it holds
        none."""
        with self._cv:
            if self._refs.get(tid, 0) > 0:
                self._refs[tid] += n
                return True
        return False
