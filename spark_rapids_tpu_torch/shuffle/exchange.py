"""Shuffle exchange (port of spark_rapids_tpu/shuffle/exchange.py: the
local lane and the shuffle-manager lane).

Local lane: every upstream partition's batches are split by the bound
partitioner (device-side partition ids, stable reorder, slices), and each
downstream partition concatenates its slices.

Manager lane (spark.rapids.shuffle.enabled, reference
`RapidsShuffleManager` write/read): map tasks run over
spark.rapids.shuffle.localExecutors executors of this process,
round-robin over the healthy ones; each map output stays spillable in the
device store through its executor's catalog, and each reduce partition
reads its local blocks from the catalog and fetches the rest over the
transport (loopback or TCP), through a recovery driver that recomputes a
lost peer's maps from the retained lineage.  Speculation and map-output
replicas ride on it when their keys are on.  The reduce side merges a
partition's batches up to the consolidation target, as the local lane
does.

Mesh lane (a mesh active, parallel/mesh.py): a hash exchange over as
many partitions as the mesh has slots, on plain key columns, runs as one
all-to-all over the mesh (parallel/collective_exchange.py), tried before
the other two lanes as in the reference: slot d owns output partition d.
The inputs are dealt round-robin to the slots (a batch past the row cap
is first cut across them), a count phase sizes the receive side from the
real totals, and the data phase pushes every row to its slot.

No lane prefetches, as the reference's do: the map side is device work
that a producer thread cannot overlap (exec/pipeline.py), and the
manager's reads already run a fetch thread.  `BroadcastExchangeExec`
collects a small build side once for a broadcast hash join.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref

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
from spark_rapids_tpu_torch.utils import checks as CK
from spark_rapids_tpu_torch.utils import profile as P


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
        mesh_axis = self._mesh_routable()
        if mesh_axis is not None:
            return self._execute_via_mesh(*mesh_axis)
        if C.get_active_conf()[C.RAPIDS_SHUFFLE_ENABLED]:
            return self._execute_via_manager()
        return [self._merged_reader(bs) for bs in self._materialize()]

    def _mesh_routable(self):
        """(mesh, axis) when the mesh lane applies: the conf enables it, a
        mesh is active on this plan's device, and the partitioning is a
        murmur3 hash over plain bound columns into as many partitions as
        the mesh has slots.  Otherwise None, and the manager or local lane
        runs (the reference's UCX data plane likewise takes over only
        inside the shuffle manager, RapidsShuffleInternalManager.scala:199)."""
        from spark_rapids_tpu_torch.exprs.base import BoundReference
        from spark_rapids_tpu_torch.parallel import mesh as PM
        from spark_rapids_tpu_torch.shuffle.partitioning import (
            HashPartitioning)
        if not C.get_active_conf()[C.MESH_EXCHANGE_ENABLED]:
            return None
        active = PM.get_active_mesh()
        if active is None:
            return None
        mesh, axis = active
        part = self.partitioning
        if not isinstance(part, HashPartitioning) \
                or part.num_partitions != mesh.shape[axis]:
            return None
        if not all(isinstance(e, BoundReference) for e in part.exprs):
            return None
        if not PM.same_device(mesh.home, self.device()):
            return None
        return mesh, axis

    #: exchanges routed through the mesh lane, and single batches past the
    #: row cap cut across the mesh before it (process-wide counters)
    _MESH_EXCHANGES_RUN = 0
    _OVERSIZED_SPLITS = 0

    def _execute_via_mesh(self, mesh, axis):
        """The mesh lane: the input dealt to the slots, one count phase and
        one data phase over the mesh, one output batch per slot."""
        from spark_rapids_tpu_torch.exec import scheduler as S
        from spark_rapids_tpu_torch.parallel.collective_exchange import (
            MeshRound, stack_batches, stacked_payload_bytes,
            unstack_batches, watched_collective)
        from spark_rapids_tpu_torch.utils import metrics as M
        from spark_rapids_tpu_torch.utils import movement as MV
        n = self.partitioning.num_partitions
        max_rows = int(C.get_active_conf()[C.MAX_BATCH_ROWS])
        groups: list = [[] for _ in range(n)]
        slot = 0
        for it in self.child.execute_partitions():
            for b in it:
                if not b.maybe_nonempty():
                    continue
                # a lazy count is bounded by the capacity: only a batch
                # that may pass the row cap pays the count's readback
                est = b.num_rows if b.num_rows_known else b.capacity
                if est > max_rows and b.num_rows > max_rows:
                    # one batch past the cap is cut across the mesh
                    # before the all-to-all, not landed whole on a slot
                    per = -(-b.num_rows // n)
                    ShuffleExchangeExec._OVERSIZED_SPLITS += 1
                    for lo in range(0, b.num_rows, per):
                        groups[slot % n].append(
                            b.slice(lo, min(per, b.num_rows - lo)))
                        slot += 1
                else:
                    groups[slot % n].append(b)
                    slot += 1
        locals_ = [concat_batches(g).dense() if g
                   else empty_batch(self._schema, self.device())
                   for g in groups]
        cap = max(b.capacity for b in locals_)
        key_idx = tuple(e.ordinal for e in self.partitioning.exprs)
        ShuffleExchangeExec._MESH_EXCHANGES_RUN += 1
        # the gate covers both phases: one whole-mesh step at a time
        with self.metrics.timed(M.TOTAL_TIME), \
                P.span("mesh-exchange", cat=P.CAT_SHUFFLE), \
                S.whole_mesh_dispatch(label="mesh-exchange"):
            arrs, num_rows = stack_batches(locals_, cap)
            del locals_, groups
            payload = count_bytes = 0
            if MV.ledger() is not None:
                payload = stacked_payload_bytes(arrs)
                count_bytes = n * n * 8
                self.metrics.add(M.COLLECTIVE_BYTES, payload + count_bytes)
            rnd = MeshRound(arrs, num_rows, self._schema, key_idx, mesh,
                            axis, cap)
            del arrs
            # the count phase sizes the receive side from the real totals
            CK.note_host_sync("exchange.mesh", nbytes=4 * n)
            totals = watched_collective(
                lambda: rnd.recv_totals().cpu().tolist(),
                label="mesh-count", nbytes=count_bytes)
            out_cap = bucket_capacity(max(max(totals), 1))
            out_arrs, _ = watched_collective(
                lambda: rnd.exchange(out_cap), label="mesh-exchange",
                nbytes=payload)
            del rnd
            out = unstack_batches(out_arrs, totals, self._schema)
        for b in out:
            self.metrics.add("dataSize", b.device_size_bytes())
        return [iter([b] if b.num_rows > 0 else []) for b in out]

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
            # constant label: one global read and a shared null context
            # when the query is not profiled
            with P.span("exchange-split", cat=P.CAT_SHUFFLE):
                slices = part.partition_batch(batch)
            for p, s in enumerate(slices):
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
        merged = concat_batches(samples)
        with self.kp_step("exchange-sample-bounds", merged.capacity,
                          device=merged.device) as kw:
            bounds = RangePartitioning.compute_bounds(
                merged, part.order, part.num_partitions)
            if kw.wants_cost():
                kw.cost(merged, bounds)
        return bounds

    _SHUFFLE_IDS = itertools.count(1)
    _SHUFFLE_IDS_LOCK = threading.Lock()

    @classmethod
    def _next_shuffle_id(cls) -> int:
        with cls._SHUFFLE_IDS_LOCK:
            return next(cls._SHUFFLE_IDS)

    def _execute_via_manager(self):
        """The manager lane (reference `_execute_via_manager`, SURVEY.md
        §3.4): map outputs land in the executors' spillable catalogs,
        reducers read through the caching reader.  The map side writes
        every map task before any partition is read; a failed map stage
        frees every executor's buffers of this shuffle; the last reader
        to finish (or close) unregisters it.  The reduce side runs
        through a ShuffleRecoveryDriver whose recompute re-runs only the
        lost map partitions of `self.child` on the reducing executor."""
        from spark_rapids_tpu_torch.exec import speculation as SPEC
        from spark_rapids_tpu_torch.shuffle.manager import MapOutputRegistry
        from spark_rapids_tpu_torch.shuffle.recovery import (
            PeerHealth, ShuffleRecoveryDriver)
        from spark_rapids_tpu_torch.utils import metrics as M
        from spark_rapids_tpu_torch.utils import watchdog as W
        conf = C.get_active_conf()
        dev = self.device()
        n_execs = max(1, int(conf[C.SHUFFLE_LOCAL_EXECUTORS]))
        names = (["local"] if n_execs == 1
                 else [f"local-{i}" for i in range(n_execs)])
        # the session's version names the manager class (the class
        # users put in spark.shuffle.manager)
        from spark_rapids_tpu_torch.shims import current_shims
        manager_cls = current_shims(conf).shuffle_manager_type()
        mgrs = [manager_cls.get_or_create(nm, device=dev) for nm in names]
        primary = mgrs[0]
        health = PeerHealth.get()
        shuffle_id = self._next_shuffle_id()
        for m in mgrs:
            m.register_shuffle(shuffle_id)
        part = self.partitioning
        if isinstance(part, RangePartitioning) and part.bounds is None:
            # two passes: the bounds' sample and the split must see the
            # same batches, so the map inputs are held once
            per_map = [[b for b in it if b.maybe_nonempty()]
                       for it in self.child.execute_partitions()]
            part.bounds = self._sample_bounds(
                part, [b.dense() for bs in per_map for b in bs
                       if b.num_rows > 0])
            map_iters = [iter(bs) for bs in per_map]
        else:
            map_iters = self.child.execute_partitions()
        n = part.num_partitions
        repl_factor = max(1, int(conf[C.SHUFFLE_REPLICATION_FACTOR]))

        def healthy_mgrs():
            ok = [m for m in mgrs
                  if not any(health.is_blacklisted(a) for a in
                             (m.loop_address, m.tcp_address) if a)]
            return ok or [primary]

        def replicas_for(mgr):
            """factor - 1 backup executors for a map task on `mgr`: the
            next healthy peers in ring order."""
            if repl_factor < 2:
                return ()
            return tuple([m for m in healthy_mgrs()
                          if m is not mgr][:repl_factor - 1])

        def write_map_task(map_id, batch_iter, mgr, epoch=None,
                           first_wins=False):
            writer = mgr.get_writer(shuffle_id, map_id,
                                    replicas=replicas_for(mgr))
            sp = P.span(f"shuffle-map:s{shuffle_id}m{map_id}",
                        cat=P.CAT_SHUFFLE) \
                if P.tracer() is not None else P._NULL_SPAN
            try:
                with sp:
                    for batch in batch_iter:
                        # a batch boundary is a cancellation point: a
                        # losing speculative attempt stops here
                        W.check_cancelled()
                        # seeded slow-task injection (the straggler
                        # model)
                        W.maybe_slow("map-task", conf=conf,
                                     executor_id=mgr.executor_id)
                        if not batch.maybe_nonempty():
                            continue
                        # a map output is published only once its
                        # deferred checks hold: an optimistic fast path
                        # that failed raises FastPathInvalid here, on the
                        # query's thread, for the collect's deopt retry
                        # (a reader would meet it only in a serializing
                        # server, as a failed fetch)
                        batch.verify_checks()
                        with self.metrics.timed(M.TOTAL_TIME), \
                                P.span("exchange-split",
                                       cat=P.CAT_SHUFFLE):
                            slices = part.partition_batch(batch)
                        for p, s in enumerate(slices):
                            if s is not None and s.num_rows > 0:
                                writer.write_partition(p, s)
                                self.metrics.add("dataSize",
                                                 s.device_size_bytes())
            except BaseException:
                writer.abort()
                raise
            writer.commit(n, epoch=epoch, first_wins=first_wins)
            if writer.replicated_bytes:
                self.metrics.add(M.REPLICATED_BYTES,
                                 writer.replicated_bytes)

        def lineage(map_id):
            # the retained map-side lineage (shared with recovery): a
            # FRESH run of exactly this child partition
            return self.child.execute_partitions()[map_id]

        def backup_for(exclude_mgr):
            ok = [m for m in healthy_mgrs() if m is not exclude_mgr]
            return ok[0] if ok else None

        spec = SPEC.maybe_create(shuffle_id, conf, self.metrics,
                                 write_map_task, lineage, backup_for,
                                 num_executors=len(mgrs))
        try:
            pool = healthy_mgrs()
            for map_id, it in enumerate(map_iters):
                mgr = pool[map_id % len(pool)]
                if spec is not None:
                    spec.run_task(map_id, it, mgr)
                else:
                    write_map_task(map_id, it, mgr)
            # arm the partial-read guard: a read over fewer outputs than
            # this FetchFails, never returns partial data
            MapOutputRegistry.set_expected_maps(shuffle_id, len(map_iters))
        except BaseException:
            # a failed map stage: no reader will run, so free the
            # completed tasks' buffers too
            for m in mgrs:
                m.unregister_shuffle(shuffle_id)
            raise
        finally:
            if spec is not None:
                spec.finish()

        driver = None
        if conf[C.SHUFFLE_RECOVERY_ENABLED]:
            def recompute(lost_map_ids, epoch):
                # only the lost map partitions, split by the same bound
                # partitioning (range bounds already sampled), onto the
                # reducing executor: the one recovery relies on
                its = self.child.execute_partitions()
                for map_id in lost_map_ids:
                    write_map_task(map_id, its[map_id], primary,
                                   epoch=epoch)
            driver = ShuffleRecoveryDriver(primary, shuffle_id, recompute,
                                           conf=conf, metrics=self.metrics)

        remaining = [n]
        lock = threading.Lock()

        def done():
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                for m in mgrs:
                    m.unregister_shuffle(shuffle_id)

        def reader(p: int, finished):
            try:
                batches = (driver.read_partition(p) if driver is not None
                           else primary.get_reader(shuffle_id, p,
                                                   metrics=self.metrics))
                for b in self._merged_reader(batches):
                    yield b
            finally:
                finished()

        readers = []
        for p in range(n):
            finished = _once(done)
            it = reader(p, finished)
            # a reader never started (its consumer failed first) runs no
            # finally: it counts as done when it is dropped
            weakref.finalize(it, finished)
            readers.append(it)
        return readers

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
                CK.note_host_sync("exchange.merge", nbytes=4 * len(unknown))
                vals = iter(torch.stack([b.num_rows_i32 for b in unknown])
                            .cpu().tolist())
                dense = [b if b.num_rows_known else
                         ColumnarBatch(b.schema, list(b.columns),
                                       int(next(vals)), b.checks)
                         for b in dense]
            live = [b for b in dense if b.num_rows > 0] or dense[:1]
            with self.kp_step("exchange-merge", live[0].capacity,
                              len(live), device=live[0].device) as kw:
                out = concat_batches(live)
                if kw.wants_cost():
                    kw.cost(live, out)
            return out

        for b in bs:
            if group and cap_sum + b.capacity > target_cap:
                yield flush()
                group, cap_sum = [], 0
            group.append(b)
            cap_sum += b.capacity
        if group:
            yield flush()


def _once(fn):
    """`fn`, called at most once however often the result is called."""
    lock = threading.Lock()
    called = [False]

    def call():
        with lock:
            if called[0]:
                return
            called[0] = True
        fn()
    return call


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
