"""Adaptive query execution (port of spark_rapids_tpu/plan/aqe.py;
reference `GpuQueryStagePrepOverrides` `GpuOverrides.scala:1873-1881`,
`GpuCustomShuffleReaderExec.scala` and the AQE hooks in
`RapidsMeta.scala:121-137`).

Spark's AQE executes a plan one shuffle "query stage" at a time, then
re-plans the rest from the runtime statistics of the materialized stages.
The two optimizations the reference takes part in:

* **partition coalescing**: adjacent small reduce partitions merge, so
  the downstream runs fewer, fatter tasks (`CustomShuffleReaderExec` over
  coalesced partition specs);
* **dynamic join demotion**: a shuffled hash join whose build side turns
  out to be under `spark.sql.autoBroadcastJoinThreshold` becomes a
  broadcast hash join.

`adaptive_execute` walks the physical plan bottom-up, materializes every
`ShuffleExchangeExec` into a `ShuffleQueryStageExec` (its reduce-side
batches held on the device), reads the per-partition sizes, and rewrites
the rest of the plan.  A stage whose materialization fails with a
`FetchFailedError` (the shuffle manager's recovery gave up) is
materialized again from scratch, as Spark resubmits a failed stage, up
to spark.rapids.shuffle.recovery.maxStageAttempts times (once with
recovery off).
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.joins import (BroadcastHashJoinExec,
                                               HashJoinExec, JoinType)
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec

log = logging.getLogger(__name__)


def query_stage_prep(cpu_plan, conf: Optional[C.RapidsConf] = None):
    """AQE preparation rule: tag the whole plan once and pin each node's
    verdict onto the node itself (`_tpu_tag`, the reference's
    TreeNodeTag), so stage-local re-plans see consistent whole-plan
    decisions.  Returns the plan unchanged."""
    from spark_rapids_tpu_torch.plan.meta import wrap_plan
    conf = conf or C.get_active_conf()
    if not conf[C.SQL_ENABLED]:
        return cpu_plan
    meta = wrap_plan(cpu_plan, conf, device="cpu")
    meta.tag_for_gpu()
    _pin_tags(meta)
    return cpu_plan


def _pin_tags(meta) -> None:
    meta.node._tpu_tag = (meta.can_this_be_replaced,
                          frozenset(meta.reasons))
    for c in meta.child_plans:
        _pin_tags(c)


#: per-partition end marker on the streaming bucket queues
_PART_DONE = object()


class ShuffleQueryStageExec(TpuExec):
    """A materialized shuffle stage: runs the wrapped exchange once,
    holds the reduce-side batches, and exposes the runtime statistics AQE
    re-plans from (Spark's `ShuffleQueryStageExec` +
    `MapOutputStatistics`).

    With pipelining on the stage materializes ASYNCHRONOUSLY: a fill
    thread drains the exchange into per-partition queues while batches
    accumulate, so sibling stages' map sides overlap (`_adapt_join`
    starts both inputs before blocking on statistics) and consumers that
    never need the statistics stream partition batches as they land.
    Reading `partition_sizes()`/`buckets` waits for the fill, so AQE
    re-planning sees what it would have seen synchronously."""

    def __init__(self, exchange: ShuffleExchangeExec):
        super().__init__()
        self.exchange = exchange
        self._schema = exchange.output_schema()
        self._buckets: Optional[list[list[ColumnarBatch]]] = None
        self._fill: Optional[threading.Thread] = None
        self._fill_error: Optional[BaseException] = None
        self._queues = None
        self._acc = None
        self._consumed: set = set()

    def output_schema(self) -> T.Schema:
        return self._schema

    def device(self):
        return self.exchange.device()

    def materialize(self) -> "ShuffleQueryStageExec":
        """Ensure materialization has STARTED (async under pipelining,
        synchronous otherwise)."""
        if self._buckets is not None or self._fill is not None:
            return self
        conf = C.get_active_conf()
        if not conf[C.PIPELINE_ENABLED]:
            self._buckets = [list(it)
                             for it in self.exchange.execute_partitions()]
            return self
        from spark_rapids_tpu_torch.exec import pipeline as PL
        from spark_rapids_tpu_torch.exec import scheduler as S
        n = self.exchange.output_partition_count()
        # unbounded queues: the slices already exist on the device;
        # bounding here would stall the map side behind the slowest
        # reduce consumer
        self._queues = [queue.Queue() for _ in range(n)]
        self._acc = [[] for _ in range(n)]
        self._consumed = set()
        self._fill_error = None
        # captured here so the fill's conf reads, cancellation, launch
        # stream and span parenting are this query's
        from spark_rapids_tpu_torch.utils import profile as P
        self._fill = threading.Thread(
            target=self._fill_run,
            args=(conf, S.current(), PL._cuda_stream_of_caller(),
                  P.current_ref()),
            daemon=True, name="tpu-aqe-stage-fill")
        self._fill.start()
        return self

    def _fill_run(self, conf, qc, stream, span_ref=None) -> None:
        from contextlib import nullcontext

        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.utils import profile as P
        from spark_rapids_tpu_torch.utils import watchdog as W
        try:
            if stream is not None:
                import torch
                torch.cuda.set_device(stream[0])
                scope = torch.cuda.stream(stream[1])
            else:
                scope = nullcontext()
            with S.scoped(qc), C.session(conf), scope, \
                    P.attach(span_ref), \
                    P.span("aqe-stage-fill", cat=P.CAT_SHUFFLE):
                hb = W.heartbeat("aqe-stage-fill", kind="task")
                with hb, W.watching(hb):
                    for p, it in enumerate(
                            self.exchange.execute_partitions()):
                        for b in it:
                            W.check_cancelled()
                            hb.beat()
                            self._acc[p].append(b)
                            self._queues[p].put(b)
                        self._queues[p].put(_PART_DONE)
        except BaseException as e:  # noqa: BLE001 — raised at readers
            self._fill_error = e
            for q in self._queues:
                q.put(_PART_DONE)

    def _finish_fill(self) -> None:
        """Wait for the fill thread and promote its batches to `_buckets`
        (raising a fill error).  The join is a bounded poll: a cancelled
        query raises out instead of waiting on a wedged fill."""
        from spark_rapids_tpu_torch.utils import watchdog as W
        t = self._fill
        if t is None:
            return
        while t.is_alive():
            W.check_cancelled()
            t.join(timeout=0.25)
        self._fill = None
        self._queues = None
        if self._fill_error is not None:
            err, self._fill_error = self._fill_error, None
            self._acc = None
            raise err
        self._buckets = self._acc
        self._acc = None

    @property
    def buckets(self) -> list[list[ColumnarBatch]]:
        # materialized again after release_stage_buffers dropped them: a
        # plan run again re-runs the exchange
        if self._buckets is None:
            self._materialize_with_retries()
        return self._buckets

    def _materialize_with_retries(self) -> None:
        """Materialize the stage, again from scratch after a
        FetchFailedError: the exchange's own recovery recomputed what it
        could, so a failure that still surfaces re-runs the WHOLE stage
        (reference plan/aqe.py:182-205), a bounded number of times."""
        from spark_rapids_tpu_torch.shuffle.client_server import (
            FetchFailedError)
        from spark_rapids_tpu_torch.utils import metrics as M
        conf = C.get_active_conf()
        allowed = (max(1, int(conf[C.SHUFFLE_RECOVERY_MAX_STAGE_ATTEMPTS]))
                   if conf[C.SHUFFLE_RECOVERY_ENABLED] else 1)
        attempt = 1
        while True:
            try:
                self.materialize()
                self._finish_fill()
                if self._buckets is None:  # an async start raced a release
                    self._buckets = [list(it) for it in
                                     self.exchange.execute_partitions()]
                return
            except FetchFailedError as e:
                self._fill = None
                self._queues = None
                self._acc = None
                self._fill_error = None
                self._consumed = set()
                if attempt >= allowed:
                    raise
                attempt += 1
                self.exchange.metrics.add(M.NUM_STAGE_RETRIES, 1)
                log.warning("AQE stage re-materialization %d/%d after "
                            "fetch failure: %s", attempt, allowed, e)

    def iter_partition(self, p: int) -> Iterator[ColumnarBatch]:
        """One partition's batches: STREAMED as they land while the fill
        is live (once per partition per materialization), else served
        from the held bucket."""
        if self._buckets is None and self._fill is not None \
                and p not in self._consumed:
            from spark_rapids_tpu_torch.utils import watchdog as W
            self._consumed.add(p)
            q = self._queues[p]
            while True:
                try:
                    b = q.get(timeout=0.25)
                except queue.Empty:
                    # bounded poll: honor a cancellation
                    W.check_cancelled()
                    continue
                if b is _PART_DONE:
                    break
                yield b
            if self._fill_error is not None:
                self._finish_fill()  # joins and raises the fill error
            return
        yield from iter(list(self.buckets[p]))

    def partition_sizes(self) -> list[int]:
        return [sum(b.device_size_bytes() for b in p)
                for p in self.buckets]

    def total_bytes(self) -> int:
        return sum(self.partition_sizes())

    def output_partition_count(self) -> int:
        return self.exchange.output_partition_count()

    def release_buckets(self) -> None:
        """Drop the held batches after the plan drained (a live fill is
        joined first, so its device memory really frees)."""
        if self._fill is not None:
            try:
                self._finish_fill()
            except BaseException:  # noqa: BLE001 — the query already
                pass               # raised its own error
        self._buckets = None
        self._acc = None
        self._consumed = set()

    def execute_partitions(self):
        self.materialize()
        return [self.iter_partition(p)
                for p in range(self.output_partition_count())]

    def release_execution_state(self) -> None:
        # the exchange's subtree hangs below the stage, not as a child
        self.exchange.release_execution_state()

    def describe(self):
        n = "?" if self._buckets is None else len(self._buckets)
        return f"ShuffleQueryStageExec(n={n})"


class CustomShuffleReaderExec(TpuExec):
    """Columnar AQE shuffle reader (reference
    `GpuCustomShuffleReaderExec.scala`): reads a materialized stage
    through partition specs, here coalesced `(start, end)` ranges of
    adjacent reduce partitions."""

    def __init__(self, stage: ShuffleQueryStageExec,
                 specs: list[tuple[int, int]]):
        super().__init__()
        self.stage = stage
        self.specs = specs
        self._schema = stage.output_schema()
        self.metrics.add("numPartitions", len(specs))

    def output_schema(self) -> T.Schema:
        return self._schema

    def device(self):
        return self.stage.device()

    def output_partition_count(self) -> int:
        return max(1, len(self.specs))

    def _read_spec(self, start: int, end: int) -> Iterator[ColumnarBatch]:
        for p in range(start, end):
            for b in self.stage.iter_partition(p):
                self.update_output_metrics(b)
                yield b

    def execute_partitions(self):
        return [self._read_spec(s, e) for s, e in self.specs]

    def describe(self):
        return (f"CustomShuffleReaderExec({len(self.specs)} specs over "
                f"{self.stage.output_partition_count()} partitions)")


def coalesce_partition_specs(sizes: list[int], target: int
                             ) -> list[tuple[int, int]]:
    """Greedy adjacent merge (Spark's `ShufflePartitionsUtil`): pack
    neighboring reduce partitions until the next would cross the advisory
    size.  Always yields at least one spec."""
    if not sizes:
        return [(0, 0)]
    specs: list[tuple[int, int]] = []
    start, acc = 0, 0
    for i, sz in enumerate(sizes):
        if i > start and acc + sz > target:
            specs.append((start, i))
            start, acc = i, 0
        acc += sz
    specs.append((start, len(sizes)))
    return specs


# ---------------------------------------------------------------------------
def adaptive_execute(plan: TpuExec,
                     conf: Optional[C.RapidsConf] = None) -> TpuExec:
    """Stage-at-a-time re-planning over a device plan.  Returns an
    equivalent plan in which every shuffle exchange is materialized into
    a query stage, small reduce partitions are coalesced, and small-build
    shuffled joins are demoted to broadcast joins."""
    conf = conf or C.get_active_conf()
    if not conf[C.ADAPTIVE_ENABLED]:
        return plan
    with C.session(conf):
        return _adapt(plan, conf)


def _adapt(node: TpuExec, conf: C.RapidsConf) -> TpuExec:
    if isinstance(node, ShuffleExchangeExec):
        return _materialize_stage(node, conf)
    if isinstance(node, HashJoinExec):
        # joins alias their probe/build children at construction: every
        # swap goes through _adapt_join, which rebinds them
        return _adapt_join(node, conf)
    for i, c in enumerate(node.children):
        node.children[i] = _adapt(c, conf)
    return node


def _materialize_stage(exchange: ShuffleExchangeExec,
                       conf: C.RapidsConf) -> TpuExec:
    exchange.children[0] = _adapt(exchange.child, conf)
    # reuse a stage _prestart_leaf_stages started, so its running map
    # side is consumed, not run twice
    stage = getattr(exchange, "_aqe_stage", None)
    if stage is None:
        stage = ShuffleQueryStageExec(exchange)
        exchange._aqe_stage = stage
    stage.materialize()
    if not conf[C.COALESCE_PARTITIONS_ENABLED]:
        return stage
    # Spark 3.1's ShuffleExchangeLike: a user's repartition pins its
    # partition count
    if not getattr(exchange, "can_change_num_partitions", True):
        return stage
    sizes = stage.partition_sizes()
    specs = coalesce_partition_specs(sizes, conf[C.ADVISORY_PARTITION_SIZE])
    if len(specs) == len(sizes):
        return stage
    log.info("AQE coalesced %d shuffle partitions into %d",
             len(sizes), len(specs))
    return CustomShuffleReaderExec(stage, specs)


def _stage_bytes(node: TpuExec) -> Optional[int]:
    """Runtime size of an already-materialized subtree, if it is one (seen
    through the coalesce the planner puts above a join's build side)."""
    from spark_rapids_tpu_torch.exec.coalesce import CoalesceBatchesExec
    if isinstance(node, CoalesceBatchesExec):
        return _stage_bytes(node.child)
    if isinstance(node, ShuffleQueryStageExec):
        return node.total_bytes()
    if isinstance(node, CustomShuffleReaderExec):
        return node.stage.total_bytes()
    return None


def _prestart_leaf_stages(node: TpuExec, conf: C.RapidsConf) -> None:
    """Start async materialization of every LEAF exchange in the subtree
    (one whose own subtree holds no other exchange or join, so running it
    early cannot bypass stage-at-a-time re-planning).  Sibling join
    inputs then run their map sides concurrently (pipelining only)."""
    if not conf[C.PIPELINE_ENABLED]:
        return
    if isinstance(node, ShuffleExchangeExec) \
            and not _subtree_replans(node.child):
        stage = getattr(node, "_aqe_stage", None)
        if stage is None:
            stage = ShuffleQueryStageExec(node)
            node._aqe_stage = stage
        stage.materialize()
        return
    for c in node.children:
        _prestart_leaf_stages(c, conf)


def _subtree_replans(node: TpuExec) -> bool:
    """True if the subtree holds a node AQE would rewrite (so its parent
    exchange must not run before `_adapt` reaches it)."""
    if isinstance(node, (ShuffleExchangeExec, HashJoinExec)):
        return True
    return any(_subtree_replans(c) for c in node.children)


def _adapt_join(join: HashJoinExec, conf: C.RapidsConf) -> TpuExec:
    _prestart_leaf_stages(join.children[0], conf)
    _prestart_leaf_stages(join.children[1], conf)
    left = _adapt(join.children[0], conf)
    right = _adapt(join.children[1], conf)
    threshold = conf[C.AUTO_BROADCAST_THRESHOLD]
    # build side: right, except RIGHT_OUTER, which builds left; Spark
    # never broadcasts a FULL OUTER join
    from spark_rapids_tpu_torch.shims import current_shims
    shims = current_shims(conf)
    build_is_left = shims.build_side_of(
        join.join_type, shims.BUILD_LEFT
        if join.join_type == JoinType.RIGHT_OUTER
        else shims.BUILD_RIGHT) == shims.BUILD_LEFT
    build = left if build_is_left else right
    size = _stage_bytes(build)
    if (not isinstance(join, BroadcastHashJoinExec)
            and threshold is not None and int(threshold) >= 0
            and join.join_type != JoinType.FULL_OUTER
            and size is not None and size <= int(threshold)):
        bcast = shims.make_broadcast_exchange(build)
        new_left = bcast if build_is_left else left
        new_right = right if build_is_left else bcast
        log.info("AQE demoted %s to broadcast join (build side %d bytes)",
                 join.describe(), size)
        return BroadcastHashJoinExec(
            join.join_type, join.left_keys, join.right_keys,
            new_left, new_right, condition=join.condition)
    join.children[0], join.children[1] = left, right
    # rebind the probe/build aliases to the adapted children
    if join._flip:
        join._probe, join._build = join.children[1], join.children[0]
    else:
        join._probe, join._build = join.children[0], join.children[1]
    return join


def release_stage_buffers(plan: TpuExec) -> None:
    """Drop every materialized stage's reduce-side batches after the plan
    has drained, so the captured plan does not pin the query's shuffle
    output in device memory."""
    if isinstance(plan, ShuffleQueryStageExec):
        plan.release_buckets()
        # stages nested below this stage's exchange hold batches too
        release_stage_buffers(plan.exchange)
        return
    if isinstance(plan, CustomShuffleReaderExec):
        release_stage_buffers(plan.stage)
        return
    for c in plan.children:
        release_stage_buffers(c)
