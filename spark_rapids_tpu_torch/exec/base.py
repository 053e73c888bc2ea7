"""Physical operator base (port of spark_rapids_tpu/exec/base.py).

A `TpuExec` produces an iterator of ColumnarBatch; Python orchestrates
batch flow while the per-batch work runs as torch ops and CUDA kernels on
the batch's device.  PyTorch runs eagerly, so the reference's compile
cache has no counterpart here.  Each exec carries its `metrics`
(utils/metrics.py) and routes its materializations through the OOM
retry harness with `oom_retry_batches` (memory/retry.py).

Observability: every subclass's `execute_partitions` returns its
partition iterators through `profile.wrap_operator` (an `Exec[pN]` span
per batch pull of a profiled query, the iterators themselves otherwise);
`kp_step` opens the kernel-attribution entry of one eager device step at
a counterpart of the reference's kernel-cache sites (utils/kernelprof.py);
`collect` emits the deopt event and, for the query it owns, assembles
the QueryProfile last.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches,
                                                   empty_batch)
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression
from spark_rapids_tpu_torch.utils import checks as CK
from spark_rapids_tpu_torch.utils import kernelprof as KP
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import profile as P


# -- coalesce goals ----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CoalesceGoal:
    pass


@dataclasses.dataclass(frozen=True)
class TargetSize(CoalesceGoal):
    bytes: int


@dataclasses.dataclass(frozen=True)
class RequireSingleBatch(CoalesceGoal):
    pass


def max_goal(a: Optional[CoalesceGoal], b: Optional[CoalesceGoal]
             ) -> Optional[CoalesceGoal]:
    if isinstance(a, RequireSingleBatch) or isinstance(b, RequireSingleBatch):
        return RequireSingleBatch()
    if isinstance(a, TargetSize) and isinstance(b, TargetSize):
        return TargetSize(max(a.bytes, b.bytes))
    return a or b


def make_eval_context(columns: list[ColumnVector], capacity: int,
                      num_rows, mask=None) -> EvalContext:
    """`mask` (a sparse selection vector) overrides the prefix row mask."""
    if mask is None:
        dev = columns[0].device
        mask = torch.arange(capacity, device=dev) < num_rows
    return EvalContext(columns, capacity, num_rows, mask)


_EXEC_IDS = itertools.count()


def new_execution() -> None:
    """Start a new execution attempt of the current query: its
    shared-subplan caches of earlier attempts stop being valid.  Epochs
    are minted from one process-wide counter but held by the query
    (exec/scheduler.py), so a concurrent query's attempt never
    invalidates this one's caches."""
    from spark_rapids_tpu_torch.exec import scheduler as S
    qc = S.current()
    if qc is not None:
        qc.epoch = S.new_epoch()


def _profiled_partitions(fn):
    """`execute_partitions` returning its iterators through
    `profile.wrap_operator`: only the most derived class's definition
    wraps (an override that calls super() gets one span per pull)."""

    @functools.wraps(fn)
    def execute_partitions(self):
        its = fn(self)
        if P.tracer() is None \
                or type(self).execute_partitions is not execute_partitions:
            return its
        return [P.wrap_operator(self, i, it) for i, it in enumerate(its)]

    execute_partitions._profiled = True
    return execute_partitions


def kp_site(label, batch_arg: int = 0):
    """Decorate an exec method that runs one eager device step at a
    counterpart of a reference kernel-cache site: with kernel
    attribution on, the call runs in `self.kp_step(label, capacity)`
    (the capacity of positional argument `batch_arg`, a ColumnarBatch),
    its analytic cost the bytes of its arguments and result.  `label`
    is a string or a function of the call's arguments; an exec with a
    `_kp_members()` method names its fused members so.  Off: one global
    read, then the method."""

    def deco(fn):
        @functools.wraps(fn)
        def site(self, *args, **kwargs):
            if not KP.enabled():
                return fn(self, *args, **kwargs)
            batch = args[batch_arg]
            lab = label(*args) if callable(label) else label
            members = getattr(self, "_kp_members", None)
            with self.kp_step(lab, batch.capacity, device=batch.device,
                              members=members() if members else None
                              ) as kw:
                out = fn(self, *args, **kwargs)
                if kw.wants_cost():
                    kw.cost(args, out)
            return out
        return site
    return deco


class TpuExec:
    """Base physical operator."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fn = cls.__dict__.get("execute_partitions")
        if fn is not None and not getattr(fn, "_profiled", False):
            cls.execute_partitions = _profiled_partitions(fn)

    def __init__(self, *children: "TpuExec"):
        self._children = list(children)
        self.metrics = M.MetricSet()
        self.exec_id = next(_EXEC_IDS)
        #: serializes collects over this plan INSTANCE (exec/scheduler.py
        #: CollectScope): its shared-subplan caches and metrics are
        #: instance state; distinct instances run concurrently
        self._plan_lock = threading.Lock()

    def _kp_scope(self) -> tuple:
        """(exec class, description): the catalog scope of this exec's
        steps, made once per instance."""
        scope = self.__dict__.get("_kp_scope_cache")
        if scope is None:
            scope = self.__dict__["_kp_scope_cache"] = (
                type(self).__name__, self.describe()[:120])
        return scope

    def kp_meta(self, label: str, members=None) -> Optional[dict]:
        """Dispatch-site metadata for the kernel catalog: a label, the
        owning exec and fused member names.  None (nothing allocated)
        while kernel attribution is off."""
        if not KP.enabled():
            return None
        return {"label": label, "owner_id": self.exec_id,
                "owner": self._kp_scope()[1],
                "members": list(members) if members else None}

    def kp_step(self, label: str, *key, device=None, members=None):
        """The kernel-attribution entry of one eager device step of this
        exec (utils/kernelprof.py): identity (exec class and
        description, the reference's kernel label and `key`), timed on
        `device` (the exec's own by default).  The shared null context
        while attribution is off."""
        if not KP.enabled():
            return KP.NULL_WATCH
        return KP.watch((self._kp_scope(), (label,) + tuple(key)),
                        self.kp_meta(label, members),
                        device if device is not None else self.device())

    @property
    def children(self) -> list["TpuExec"]:
        return self._children

    @property
    def child(self) -> "TpuExec":
        return self._children[0]

    def output_schema(self) -> T.Schema:
        raise NotImplementedError

    def device(self) -> torch.device:
        """The device this plan runs on (its leaf's)."""
        return self.child.device()

    def output_partition_count(self) -> int:
        """Planning-time partition count; executes nothing."""
        if not self._children:
            return 1
        return self._children[0].output_partition_count()

    @property
    def coalesce_after(self) -> bool:
        """True when this exec shrinks batches, so a coalesce above it
        pays off."""
        return False

    def children_coalesce_goal(self) -> list[Optional[CoalesceGoal]]:
        return [None] * len(self._children)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        for it in self.execute_partitions():
            yield from it

    def execute_partitions(self) -> list[Iterator[ColumnarBatch]]:
        raise NotImplementedError

    #: bounded deopt attempts: intermediate retries may take fast paths
    #: with escalated parameters and fail again; only the LAST runs with
    #: every fast path forced off (is_retrying) for a guaranteed-valid
    #: result
    MAX_DEOPT_RETRIES = 3

    def collect(self) -> ColumnarBatch:
        """Materialize to one batch: the sync boundary where deferred
        fast-path checks resolve.  On FastPathInvalid, disable or escalate
        the fast paths at fault and re-execute (plans are pure), up to
        MAX_DEOPT_RETRIES times.

        Concurrency: the outermost collect on a thread with no live
        QueryContext creates one (exec/scheduler.py CollectScope): its
        own conf snapshot, CancelToken, deferred-check registry, epoch
        and an admission slot, so top-level collects from different
        sessions run concurrently, each isolated."""
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.utils import watchdog as W
        if S.current() is None:
            # a fresh fallback token: an earlier query-less cancellation
            # must not bleed in
            W.begin_query()
        scope = S.CollectScope(self)
        prof_owner = scope.prof_owner if scope.owns_qc else None
        prof_error: Optional[BaseException] = None
        try:
            return self._collect_attempts()
        except BaseException as e:
            prof_error = e
            raise
        finally:
            if scope.finish_collect():
                # only the OUTERMOST collect drops shared-subtree caches:
                # a nested collect (a range exchange's sample sort) must
                # not clear the enclosing query's
                self.release_execution_state()
                qs = W.query_stats()
                if qs["timeouts"] or qs["cancels"]:
                    # charge watchdog activity to the plan root only on a
                    # tripped query
                    self.metrics.add(M.NUM_WATCHDOG_TIMEOUTS,
                                     qs["timeouts"])
                    self.metrics.add(M.NUM_CANCELS, qs["cancels"])
                    self.metrics.add(M.WATCHDOG_DUMPS, qs["dumps"])
                    self.metrics.set_max(M.SLOWEST_HEARTBEAT,
                                         qs["slowest_heartbeat_ms"])
                # assemble the QueryProfile LAST so the plan report sees
                # every metric this query charged
                P.end_query(prof_owner, self, error=prof_error)
            # the error's traceback holds this frame: keeping the error
            # here too would make a cycle that holds every frame of the
            # failed plan, and its tensors, until the next collection
            prof_error = None
            scope.close()

    def _collect_attempts(self) -> ColumnarBatch:
        from spark_rapids_tpu_torch.utils import watchdog as W
        mark = CK.snapshot()
        for attempt in range(self.MAX_DEOPT_RETRIES + 1):
            # attempt boundary = cancellation point: a cancelled query
            # does not start another execution
            W.check_cancelled()
            final = attempt == self.MAX_DEOPT_RETRIES
            if attempt:
                CK.set_retrying(final)
            try:
                out = self._collect_once().dense()
                checks = list(out.checks) + CK.drain_since(mark)
                # the lazy row count rides the same readback as the flags
                if out.num_rows_known:
                    CK.verify(checks)
                else:
                    (rows,) = CK.verify(checks, scalars=[out.num_rows_i32])
                    out.num_rows = int(rows)
                return out
            except CK.FastPathInvalid as e:
                if final:
                    raise
                e.recover_all()
                P.event(P.EV_DEOPT_RETRY, origin=", ".join(
                    c.origin for c in e.checks))
                CK.drain_since(mark)  # discard this attempt's rest
            finally:
                if attempt:
                    CK.set_retrying(False)
        raise AssertionError("unreachable")

    def _collect_once(self) -> ColumnarBatch:
        from spark_rapids_tpu_torch.exec import scheduler as S
        qc = S.current()
        if qc is not None and qc.collect_depth <= 1:
            # a new top-level attempt: shared subtrees run again.  A
            # nested collect (a range exchange's sample sort) must not
            # bump the epoch of the enclosing query
            new_execution()
        # through execute_partitions, so a profiled root gets its span
        # even where it overrides execute_columnar
        batches = [b for it in self.execute_partitions() for b in it]
        if not batches:
            return empty_batch(self.output_schema(), self.device())
        return concat_batches(batches, sparse_ok=True)

    def release_execution_state(self) -> None:
        """Drop what an execution cached (CommonSubplanExec batches), so
        a finished query holds no device memory through its plan."""
        for c in self._children:
            c.release_execution_state()

    def to_pandas(self):
        return self.collect().to_pandas()

    def update_output_metrics(self, batch: ColumnarBatch) -> None:
        """Charge one output batch; a lazy row count queues (no sync)."""
        self.metrics.add(M.NUM_OUTPUT_ROWS, batch._rows)
        self.metrics.add(M.NUM_OUTPUT_BATCHES, 1)

    def oom_retry_batches(self, batch: ColumnarBatch, body,
                          split: bool = True, out_bytes_fn=None,
                          label: Optional[str] = None):
        """Reservation-aware batch processing: route one batch's
        materialization through the OOM retry harness (memory/retry.py)
        — reserve device memory for the output, spill under pressure
        with the semaphore yielded, split the input in half and retry on
        reservation failure, and past the row floor degrade via the
        conf'd fallback.  Yields one `body(piece)` result per (possibly
        split) piece in row order, charging this exec's numRetries /
        numSplitRetries / spillBytes / retryBlockTime metrics.

        `split=False` is for single-batch contracts that cannot
        subdivide their input (window frames, RequireSingleBatch
        consumers): pressure there spills + retries in place and the
        floor fallback handles the rest."""
        from spark_rapids_tpu_torch.memory import retry as R
        from spark_rapids_tpu_torch.utils import watchdog as W
        label = label or self.name()
        # batch boundary = cancellation point: a cancelled query stops
        # dispatching new work here
        W.check_cancelled()
        if split:
            for out in R.with_split_retry(
                    batch, body, metrics=self.metrics,
                    out_bytes_fn=out_bytes_fn, label=label):
                W.check_cancelled()
                yield out
        else:
            nbytes = (out_bytes_fn or R.estimate_batch_bytes)(batch)
            yield R.with_retry(lambda: body(batch), out_bytes=nbytes,
                               metrics=self.metrics, label=label,
                               device=batch.device)

    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name()

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self._children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    def __repr__(self):
        return self.tree_string()


class SchemaOnlyExec(TpuExec):
    """Placeholder child carrying just a schema, for internal helper
    execs (merge nodes)."""

    def __init__(self, schema: T.Schema):
        super().__init__()
        self._schema = schema

    def output_schema(self) -> T.Schema:
        return self._schema


class CommonSubplanExec(TpuExec):
    """Execute-once wrapper of a subtree that several parents share: the
    first consumer in an execution runs it and keeps its batches, the
    others read them back (the role of Spark's ReusedExchangeExec)."""

    def __init__(self, child: TpuExec):
        super().__init__(child)
        self._epoch = -1
        self._cached = None

    def output_schema(self):
        return self.child.output_schema()

    @property
    def coalesce_after(self) -> bool:
        # transparent for coalesce insertion
        return self.child.coalesce_after

    def execute_partitions(self):
        from spark_rapids_tpu_torch.exec import scheduler as S
        epoch = S.current_epoch()
        if self._epoch != epoch:
            self._cached = [list(it)
                            for it in self.child.execute_partitions()]
            self._epoch = epoch
        return [iter(p) for p in self._cached]

    def release_execution_state(self) -> None:
        self._cached = None
        self._epoch = -1
        super().release_execution_state()


class UnaryExecBase(TpuExec):
    """Partition-local single-child operator: processes one child batch
    iterator into an output iterator."""

    def process_partition(self, batches: Iterator[ColumnarBatch]
                          ) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def execute_partitions(self):
        return [self.process_partition(it)
                for it in self.child.execute_partitions()]


def bind_exprs(exprs: Sequence[Expression], schema: T.Schema
               ) -> list[Expression]:
    return [e.bind(schema) for e in exprs]
