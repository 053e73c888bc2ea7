"""Shuffle exchange (port of spark_rapids_tpu/shuffle/exchange.py: the
local lane).

Every upstream partition's batches are split by the bound partitioner
(device-side partition ids, stable reorder, slices), and each downstream
partition concatenates its slices.  The reference's other two lanes, the
device-mesh all-to-all and the shuffle manager, are not ported: the
manager's conf key raises here rather than running the local lane in its
place, and the mesh lane needs an active device mesh, which the port
cannot set, so its key engages nothing.  Neither side of the local lane
prefetches, as the reference's does: its input is device work that a
producer thread cannot overlap (exec/pipeline.py).
`BroadcastExchangeExec` collects a small build side once for a broadcast
hash join.
"""
from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches,
                                                   empty_batch)
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.exec.base import TpuExec, UnaryExecBase
from spark_rapids_tpu_torch.shuffle.partitioning import (RangePartitioning,
                                                         TpuPartitioning)


class ShuffleExchangeExec(UnaryExecBase):
    #: below this many input rows a range exchange degenerates to one
    #: partition: a one-partition sort is already globally ordered
    SMALL_RANGE_INPUT_ROWS = 1 << 15
    #: a coalesce_small exchange whose total input CAPACITY stays at or
    #: below this emits one partition and skips the split
    SMALL_COALESCE_INPUT_CAP = 1 << 16
    #: reduce-side consolidation target: a partition's slices merge up
    #: to this capacity before flowing downstream
    MERGE_TARGET_CAP = 1 << 16

    def __init__(self, partitioning: TpuPartitioning, child: TpuExec,
                 coalesce_small: bool = False):
        super().__init__(child)
        self._schema = child.output_schema()
        self.partitioning = partitioning.bind(self._schema)
        #: planner-set: the consumer needs key CLUSTERING only (a final
        #: aggregation), so a small input may land in one partition.
        #: Never set for join inputs.
        self.coalesce_small = coalesce_small

    def output_schema(self) -> T.Schema:
        return self._schema

    def output_partition_count(self) -> int:
        return self.partitioning.num_partitions

    def describe(self):
        return (f"ShuffleExchangeExec({type(self.partitioning).__name__}, "
                f"n={self.partitioning.num_partitions})")

    def execute_partitions(self):
        if C.get_active_conf()[C.RAPIDS_SHUFFLE_ENABLED]:
            raise NotImplementedError(
                "the shuffle-manager exchange lane is not ported yet "
                f"(set {C.RAPIDS_SHUFFLE_ENABLED.key}=false)")
        return [self._merged_reader(bs) for bs in self._materialize()]

    def _materialize(self) -> list[list[ColumnarBatch]]:
        """Run the map side: split every input batch; bucket by target."""
        buckets: list = [[] for _ in range(self.partitioning.num_partitions)]
        for p, s in self._split_slices():
            buckets[p].append(s)
        return buckets

    def _split_slices(self):
        """The map side as a stream of (partition, slice) pairs."""
        part = self.partitioning
        inputs = (b for it in self.child.execute_partitions() for b in it
                  if b.maybe_nonempty())
        if isinstance(part, RangePartitioning):
            inputs, small = self._range_inputs(inputs)
            if small:
                for b in inputs:
                    yield 0, b
                return
        elif self.coalesce_small and part.num_partitions > 1:
            head, cap_seen = [], 0
            for b in inputs:
                head.append(b)
                cap_seen += b.capacity
                if cap_seen > self.SMALL_COALESCE_INPUT_CAP:
                    break
            else:
                for b in head:
                    yield 0, b
                return
            inputs = itertools.chain(head, inputs)
        for batch in inputs:
            for p, s in enumerate(part.partition_batch(batch)):
                if s is not None and s.maybe_nonempty():
                    yield p, s

    def _range_inputs(self, inputs):
        """Range partitioning passes over its input twice (sample the
        bounds, then split), so the input is materialized here.  Returns
        (inputs, small): `small` means one partition suffices."""
        inputs = [b.dense() for b in inputs]
        inputs = [b for b in inputs if b.num_rows > 0]
        total = sum(b.num_rows for b in inputs)
        n = self.partitioning.num_partitions
        small = total <= self.SMALL_RANGE_INPUT_ROWS or n == 1
        if not small and self.partitioning.bounds is None:
            self.partitioning.bounds = self._sample_bounds(
                self.partitioning, inputs)
        return inputs, small

    def _sample_bounds(self, part: RangePartitioning, inputs):
        """Evenly spaced sample rows of each input batch (the reference
        engine's striding in place of reservoir sampling), sorted, cut
        at evenly spaced split points."""
        samples, sample_rows = [], 0
        target = 20 * part.num_partitions
        for batch in inputs:
            take = min(batch.num_rows, max(2, target))
            idx = np.linspace(0, batch.num_rows - 1, take).astype(np.int64)
            cap = bucket_capacity(take)
            sel = torch.from_numpy(np.pad(idx, (0, cap - take))).to(
                batch.device)
            valid = torch.arange(cap, device=batch.device) < take
            samples.append(batch.gather(sel, valid, take))
            sample_rows += take
            if sample_rows >= 4 * target:
                break
        if not samples:
            return empty_batch(self._schema, self.device())
        return RangePartitioning.compute_bounds(
            concat_batches(samples), part.order, part.num_partitions)

    def _merged_reader(self, bs: list[ColumnarBatch]):
        """A partition's slices, merged device-side up to the
        consolidation target."""
        target_cap = max(self.MERGE_TARGET_CAP, bucket_capacity(
            int(C.get_active_conf()[C.MAX_BATCH_ROWS])))
        group: list[ColumnarBatch] = []
        cap_sum = 0

        def flush():
            if len(group) == 1:
                return group[0]
            if self.coalesce_small:
                # the consumer compacts its groups right away, so the
                # lazy concat's worst-case capacity does not propagate
                return concat_batches(list(group))
            # read the slices' row counts back at once and concat TIGHT
            dense = [b.dense() for b in group]
            unknown = [b for b in dense if not b.num_rows_known]
            if unknown:
                vals = iter(torch.stack([b.num_rows_i32 for b in unknown])
                            .cpu().tolist())
                dense = [b if b.num_rows_known else
                         ColumnarBatch(b.schema, list(b.columns),
                                       int(next(vals)), b.checks)
                         for b in dense]
            return concat_batches([b for b in dense if b.num_rows > 0]
                                  or dense[:1])

        for b in bs:
            if group and cap_sum + b.capacity > target_cap:
                yield flush()
                group, cap_sum = [], 0
            group.append(b)
            cap_sum += b.capacity
        if group:
            yield flush()


class BroadcastTimeoutError(RuntimeError):
    """Build-side materialization exceeded spark.sql.broadcastTimeout
    (the reference's 'Could not execute broadcast in N secs')."""


class BroadcastTooLargeError(RuntimeError):
    """Build side exceeded spark.rapids.tpu.maxBroadcastTableBytes
    (Spark's 8GB broadcast-table limit)."""


class BroadcastExchangeExec(UnaryExecBase):
    """Collect the (small) build side once; every consumer gets the same
    single batch (reference GpuBroadcastExchangeExec).

    The build collect is bounded by spark.sql.broadcastTimeout and its
    device bytes by spark.rapids.tpu.maxBroadcastTableBytes, so a runaway
    build side fails with a clear error instead of hanging the query or
    exhausting device memory.  The timeout is cooperative: checked between
    build-side batches (one wedged batch is the watchdog's to catch).
    The batch is held for one execution and dropped with the query's
    other execution state."""

    def __init__(self, child: TpuExec):
        super().__init__(child)
        self._schema = child.output_schema()
        self._cached = None
        self._lock = threading.Lock()

    def output_schema(self) -> T.Schema:
        return self._schema

    def output_partition_count(self) -> int:
        return 1

    def describe(self):
        return "BroadcastExchangeExec"

    def broadcast_batch(self) -> ColumnarBatch:
        with self._lock:
            if self._cached is None:
                self._cached = self._materialize_build()
            return self._cached

    def _materialize_build(self) -> ColumnarBatch:
        from spark_rapids_tpu_torch.utils import watchdog as W
        conf = C.get_active_conf()
        timeout_s = float(conf[C.BROADCAST_TIMEOUT])
        max_bytes = int(conf[C.MAX_BROADCAST_TABLE_BYTES])
        with self.metrics.timed("broadcastTime"):
            t0 = time.monotonic()
            batches, total = [], 0
            for it in self.child.execute_partitions():
                for b in it:
                    W.check_cancelled()
                    if not b.maybe_nonempty():
                        continue
                    batches.append(b.dense())
                    total += b.device_size_bytes()
                    if total > max_bytes:
                        raise BroadcastTooLargeError(
                            f"broadcast build side reached {total} bytes > "
                            f"{C.MAX_BROADCAST_TABLE_BYTES.key}="
                            f"{max_bytes}")
                    if time.monotonic() - t0 > timeout_s:
                        raise BroadcastTimeoutError(
                            f"could not execute broadcast in {timeout_s} "
                            f"secs ({C.BROADCAST_TIMEOUT.key})")
            out = (concat_batches(batches) if batches
                   else empty_batch(self._schema, self.device()))
            self.metrics.add("dataSize", out.device_size_bytes())
        return out

    def execute_partitions(self):
        return [iter([self.broadcast_batch()])]

    def release_execution_state(self) -> None:
        with self._lock:
            self._cached = None
        super().release_execution_state()
