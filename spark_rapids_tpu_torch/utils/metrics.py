"""Operator metrics (port of spark_rapids_tpu/utils/metrics.py: the metric
names and `MetricSet`, surfaced by `TpuExec.metrics`).

The names are the reference's, so one report reads both packages.  Values
may be device scalars (a lazy row count): they queue, and a read resolves
every queued one in one stacked readback per dtype, so charging a metric
never waits for the device.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
NUM_INPUT_ROWS = "numInputRows"
NUM_INPUT_BATCHES = "numInputBatches"
TOTAL_TIME = "totalTime"
# OOM retry harness (memory/retry.py charges these to the exec whose
# materialization hit pressure)
NUM_RETRIES = "numRetries"
NUM_SPLIT_RETRIES = "numSplitRetries"
NUM_OOM_FALLBACKS = "numOomFallbacks"
SPILL_BYTES = "spillBytes"
RETRY_BLOCK_TIME = "retryBlockTime"
# out-of-core lane (memory/oocore.py): spillRunBytes is the serialized
# bytes an exec pushed through the spill tiers as sorted-run / grace
# partition / partial-agg state, numExternalMergePasses counts windowed
# merge/re-merge rounds, numGracePartitions the hash-partition fan-outs
# (summed across recursion depths), numSpillCorruptionsRecovered the
# corrupt spill re-reads that recovered from a replica or recompute
SPILL_RUN_BYTES = "spillRunBytes"
NUM_EXTERNAL_MERGE_PASSES = "numExternalMergePasses"
NUM_GRACE_PARTITIONS = "numGracePartitions"
NUM_SPILL_CORRUPTIONS_RECOVERED = "numSpillCorruptionsRecovered"
# file scans (io/scan.py): host decode time before the upload, the
# upload's own time (both ns, like totalTime) and the bytes it put on the
# device
BUFFER_TIME = "bufferTime"
DECODE_TIME = "tpuDecodeTime"
UPLOAD_BYTES = "uploadBytes"
# the prefetch pipeline (exec/pipeline.py): consumer wait (ns), pulls
# served from the queue, pulls that had to wait
PIPELINE_WAIT_TIME = "pipelineWaitTime"
PREFETCH_HITS = "prefetchHits"
PREFETCH_STALLS = "prefetchStalls"
# the watchdog (utils/watchdog.py), charged to a tripped query's root
NUM_WATCHDOG_TIMEOUTS = "numWatchdogTimeouts"
NUM_CANCELS = "numCancels"
WATCHDOG_DUMPS = "watchdogDumps"
SLOWEST_HEARTBEAT = "slowestHeartbeatMs"
# the SPMD lane (exec/spmd.py): a fused stage's gang dispatches over the
# mesh (one per stage execution, whatever the partition count) and gangs
# that fell back to the per-partition lane
NUM_SPMD_DISPATCHES = "numSpmdDispatches"
NUM_SPMD_DEOPTS = "numSpmdDeopts"
# the shuffle manager lane's recovery (shuffle/recovery.py, plan/aqe.py)
# residency ledger (utils/residency.py): tracked buffers still
# attributed to a query when it finished, charged to the collected plan
# root by the end-of-query leak check
NUM_RESIDENCY_LEAKS = "numResidencyLeaks"
NUM_FETCH_FAILURES = "numFetchFailures"
NUM_MAP_RECOMPUTES = "numMapRecomputes"
NUM_STAGE_RETRIES = "numStageRetries"
NUM_PEERS_BLACKLISTED = "numPeersBlacklisted"
RECOVERY_TIME = "recoveryTime"
# tail tolerance (exec/speculation.py, hedged fetches, map-output
# replicas), and wire payloads whose CRC caught in-flight damage
NUM_SPECULATIVE_TASKS = "numSpeculativeTasks"
NUM_SPECULATIVE_WINS = "numSpeculativeWins"
NUM_HEDGED_FETCHES = "numHedgedFetches"
NUM_HEDGED_WINS = "numHedgedWins"
REPLICATED_BYTES = "replicatedBytes"
NUM_REPLICA_PROMOTIONS = "numReplicaPromotions"
NUM_WIRE_CORRUPTIONS = "numWireCorruptions"
# the payload bytes a mesh exchange or SPMD gang put on the collective
# edge (parallel/collective_exchange.py stacked_payload_bytes)
COLLECTIVE_BYTES = "collectiveBytes"
# wire bytes a manager-lane exchange's readers pulled, compressed and not
SHUFFLE_COMPRESSED_BYTES = "shuffleCompressedBytes"
SHUFFLE_RAW_BYTES = "shuffleUncompressedBytes"
# the reference's other names come with the layers that charge them


class MetricSet:
    """Counters that accept LAZY (device-scalar) values: adding a row
    count still being computed must not wait for the device, so device
    values queue and resolve only when a metric is read.  A prefetch
    producer and its consumer charge one exec's set from two threads, so
    every update holds the set's lock."""

    def __init__(self):
        self._values = defaultdict(float)
        #: queued (name, value, op) updates; op is "add" or "max"
        self._pending: list = []
        self._lock = threading.Lock()

    def add(self, name: str, value) -> None:
        with self._lock:
            if isinstance(value, (int, float)):
                self._values[name] += value
            else:
                self._pending.append((name, value, "add"))

    def set_max(self, name: str, value) -> None:
        """Raise `name` to at least `value`.  Queues like `add`, so a
        peak tracker on the hot path never waits for the device."""
        with self._lock:
            self._pending.append((name, value, "max"))

    def _resolve(self) -> None:
        with self._lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
        # ONE stacked readback per (dtype, device) group for the whole
        # queue: a read per value would cost a device round trip each
        resolved: list = [None] * len(pending)
        groups: dict = {}
        for i, (_, v, _) in enumerate(pending):
            if isinstance(v, (int, float)):
                resolved[i] = float(v)
                continue
            t = torch.as_tensor(v).reshape(())
            groups.setdefault((t.dtype, t.device), []).append((i, t))
        from spark_rapids_tpu_torch.utils import checks as CK
        for items in groups.values():
            CK.note_host_sync("metrics.resolve", nbytes=8 * len(items))
            vals = torch.stack([t for _, t in items]).cpu().tolist()
            for (i, _), val in zip(items, vals):
                resolved[i] = float(val)
        # FIFO order, so interleaved add/max see what eager resolves would
        with self._lock:
            for (name, _, op), val in zip(pending, resolved):
                if op == "max":
                    self._values[name] = max(self._values[name], val)
                else:
                    self._values[name] += val

    def value(self, name: str) -> float:
        self._resolve()
        with self._lock:
            return self._values[name]

    @contextmanager
    def timed(self, name: str = TOTAL_TIME):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, time.perf_counter_ns() - t0)

    def as_dict(self) -> dict:
        self._resolve()
        with self._lock:
            return dict(self._values)

    def __repr__(self):
        return f"MetricSet({self.as_dict()})"
