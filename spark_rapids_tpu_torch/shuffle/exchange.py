"""Shuffle exchange (port of spark_rapids_tpu/shuffle/exchange.py: the
local lane).

Every upstream partition's batches are split by the bound partitioner
(device-side partition ids, stable reorder, slices), and each downstream
partition concatenates its slices.  The reference's other two lanes, the
device-mesh all-to-all and the shuffle manager, are not ported: the
manager's conf key raises here rather than running the local lane in its
place, and the mesh lane needs an active device mesh, which the port
cannot set, so its key engages nothing.
"""
from __future__ import annotations

import itertools

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
