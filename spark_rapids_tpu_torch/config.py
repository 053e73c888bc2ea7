"""Typed configuration registry (port of spark_rapids_tpu/config.py, cut to
the keys the port's paths read).

Keys keep their `spark.rapids.*` names and defaults, so one conf dict
drives both packages.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Callable, Optional

_REGISTRY: dict[str, "ConfEntry"] = {}


@dataclasses.dataclass
class ConfEntry:
    key: str
    default: Any
    doc: str
    converter: Callable[[str], Any]
    #: a test-only or engine-internal key, left out of user docs
    internal: bool = False


def _bool(s):
    return s if isinstance(s, bool) else str(s).lower() in ("true", "1", "yes")


def conf(key: str, default: Any, doc: str,
         internal: bool = False) -> ConfEntry:
    conv = {bool: _bool, int: int, float: float, str: str}[type(default)]
    entry = ConfEntry(key, default, doc, conv, internal)
    _REGISTRY[key] = entry
    return entry


# --- core enables -----------------------------------------------------------
SQL_ENABLED = conf("spark.rapids.sql.enabled", True,
                   "Enable or disable GPU SQL acceleration entirely.")
EXPLAIN = conf("spark.rapids.sql.explain", "NONE",
               "Explain why parts of a plan were not placed on the GPU: "
               "NONE, NOT_ON_GPU, ALL.")
TEST_ENABLED = conf("spark.rapids.sql.test.enabled", False,
                    "Testing hook: fail if an op expected on the GPU falls "
                    "back.")
TEST_ALLOWED_NONGPU = conf("spark.rapids.sql.test.allowedNonGpu", "",
                           "Comma-separated ops allowed on CPU in test mode.")
MAX_BATCH_ROWS = conf("spark.rapids.tpu.batchMaxRows", 65536,
                      "Row cap per device batch at upload and coalesce "
                      "boundaries.")
PRUNE_COLUMNS = conf("spark.rapids.tpu.columnPruning.enabled", True,
                     "Prune unreferenced columns at source leaves before "
                     "plan rewrite (the role Catalyst's ColumnPruning plays "
                     "for Spark).")
BATCH_SIZE_BYTES = conf("spark.rapids.sql.batchSizeBytes", 2147483136,
                        "Target device batch size in bytes for coalescing.")
MAX_READER_BATCH_ROWS = conf("spark.rapids.sql.reader.batchSizeRows",
                             2147483647, "Max rows per scan batch.")
MAX_READER_BATCH_BYTES = conf("spark.rapids.sql.reader.batchSizeBytes",
                              2147483136, "Soft max bytes per scan batch.")
REPLACE_SORT_MERGE_JOIN = conf(
    "spark.rapids.sql.replaceSortMergeJoin.enabled", True,
    "Replace SortMergeJoin with a GPU shuffled hash join.")
SPARK_VERSION = conf("spark.rapids.tpu.sparkVersion", "3.0.1",
                     "Spark version the session emulates; selects the "
                     "shim set.")
ALLOW_UNKNOWN_SPARK_VERSION = conf(
    "spark.rapids.tpu.allowUnknownSparkVersion", False,
    "When no shim matches the Spark version exactly, fall back to the "
    "nearest same-minor shim with a warning instead of failing "
    "(default: fail).")
EXPORT_COLUMNAR_RDD = conf(
    "spark.rapids.sql.exportColumnarRdd", False,
    "Allow ml.ColumnarRdd to hand a plan's device batches to ML code "
    "as tensors that stay on the card.")
FUSION_ENABLED = conf(
    "spark.rapids.sql.fusion.enabled", True,
    "Collapse Project/Filter chains between pipeline breaks into one "
    "stage, and fold a chain that feeds a partial or complete "
    "aggregation into the aggregate's update lane.")
SPMD_ENABLED = conf(
    "spark.rapids.sql.spmd.enabled", False,
    "Run each fused stage as one gang over the active device mesh "
    "(exec/spmd.py): the stage's partition batches are stacked along a "
    "slot axis, padded to one capacity with per-slot row masks so ragged "
    "partitions stay exact, and the composed project/filter chain runs "
    "once per physical device over all its slots: one launch sequence "
    "per stage instead of one per partition.  Requires an active mesh "
    "(spark_rapids_tpu_torch.parallel.mesh.set_active_mesh); without "
    "one, or for a stage the gang cannot run (uneven narrow shadows, an "
    "expression that reads the task context, a failed stack), the stage "
    "runs on the per-partition lane (numSpmdDeopts).  Also changes the "
    "plan's shape: fusible chains stay standalone FusedStageExec nodes "
    "(single operators included) instead of folding into the "
    "aggregate's update lane.  Off (default): the per-partition engine.")
DENSE_JOIN_ENABLED = conf(
    "spark.rapids.tpu.denseJoin.enabled", True,
    "Direct-address equi-join fast path: when a single integral build "
    "key's runtime span fits denseJoin.maxSpan and the keys are unique "
    "(PK-FK joins on dense surrogate keys), the build side becomes a "
    "dense slot table, and each probe batch is a lookup of its keys' "
    "slots in that table followed by gathers of the build rows, with no "
    "concat and no sort.  Otherwise the join takes the sort-merge lane.")
DENSE_JOIN_MAX_SPAN = conf(
    "spark.rapids.tpu.denseJoin.maxSpan", 1 << 22,
    "Max build-key span for the direct-address join table (table memory "
    "is 8 bytes per slot).")
RAPIDS_SHUFFLE_ENABLED = conf(
    "spark.rapids.shuffle.enabled", False,
    "Route exchanges through the accelerated shuffle manager (map "
    "outputs held spillable in the device store, reduce partitions "
    "read from the catalog or fetched over the transport, "
    "shuffle/manager.py) instead of the in-process exchange.")
MESH_EXCHANGE_ENABLED = conf(
    "spark.rapids.shuffle.meshExchange.enabled", True,
    "Route hash exchanges through the device-mesh all-to-all "
    "(parallel/collective_exchange.py) when a mesh is active "
    "(spark_rapids_tpu_torch.parallel.mesh.set_active_mesh) and the "
    "exchange is mesh-routable (hash keys are plain columns, partition "
    "count == mesh size; the planner plans hash exchanges at the mesh "
    "size while one is active).  Otherwise the manager or local lane "
    "runs.")

# --- the shuffle manager lane (shuffle/manager.py and its transport) -------
SHUFFLE_TRANSPORT_CLASS = conf(
    "spark.rapids.shuffle.transport.class",
    "spark_rapids_tpu_torch.shuffle.ici_transport.IciShuffleTransport",
    "Fully-qualified RapidsShuffleTransport implementation.  A class "
    "of the JAX package (a module under spark_rapids_tpu.) is refused "
    "with a ValueError naming this default, never imported.")
SHUFFLE_MAX_RECV_INFLIGHT = conf(
    "spark.rapids.shuffle.maxMetadataFetchSize", 1073741824,
    "Max in-flight receive bytes per client (throttle).")
SHUFFLE_BOUNCE_BUFFER_SIZE = conf(
    "spark.rapids.shuffle.bounceBuffers.size", 4194304,
    "Bounce/staging buffer size for cross-slice (DCN) transfers.")
SHUFFLE_BOUNCE_BUFFER_COUNT = conf(
    "spark.rapids.shuffle.bounceBuffers.count", 32,
    "Number of staging buffers per transport direction.")
SHUFFLE_COMPRESSION_CODEC = conf(
    "spark.rapids.shuffle.compression.codec", "none",
    "Codec for serialized shuffle payloads on the transport wire: "
    "none, copy (testing), lz4, zstd.")
SHUFFLE_FAULT_DROP_RATE = conf(
    "spark.rapids.shuffle.transport.faultInjection.dropRate", 0.0,
    "TEST ONLY: probability that the transport server aborts a "
    "transfer mid-stream (connection-loss injection; the reference "
    "builds UCX with --enable-fault-injection for the same class of "
    "soak testing). The client's bounded-retry path must recover.",
    internal=True)
SHUFFLE_FAULT_CORRUPT_RATE = conf(
    "spark.rapids.shuffle.transport.faultInjection.corruptRate", 0.0,
    "TEST ONLY: probability that a DATA chunk payload is corrupted on "
    "the wire; the receiver's deserialization/CRC checks must detect "
    "it and the fetch must retry.", internal=True)
SHUFFLE_FAULT_SEED = conf(
    "spark.rapids.shuffle.transport.faultInjection.seed", 0,
    "Deterministic seed for fault injection.", internal=True)
SHUFFLE_FAULT_PEER_KILL_FRAMES = conf(
    "spark.rapids.shuffle.transport.faultInjection.peerKillAfterFrames", 0,
    "TEST ONLY: after serving this many DATA frames (across both the "
    "TCP and loopback lanes) the transport kills its own peer: sockets "
    "close mid-stream, the accept loop stops, and the loopback "
    "registration disappears — a hard executor loss, not a polite "
    "error.  The shuffle fault-recovery subsystem must invalidate the "
    "peer's map outputs and recompute them.  0 disables.",
    internal=True)
SHUFFLE_FETCH_MAX_RETRIES = conf(
    "spark.rapids.shuffle.fetch.maxRetries", 3,
    "Transfer-level retry budget per peer fetch: a failed transaction "
    "(mid-stream abort, wire corruption, dead socket) is retried on a "
    "fresh connection up to this many times before the fetch surfaces "
    "a FetchFailedError to the stage-recovery layer (reference "
    "RapidsShuffleClient FetchRetry).")
SHUFFLE_FETCH_BACKOFF_BASE_MS = conf(
    "spark.rapids.shuffle.fetch.backoff.baseMs", 50.0,
    "Base delay for exponential backoff between fetch retries: attempt "
    "k sleeps min(capMs, baseMs * 2^(k-1)) with +/-50% deterministic "
    "jitter (seeded from faultInjection.seed when set), so a flapping "
    "peer is not hammered with immediate reconnects.")
SHUFFLE_FETCH_BACKOFF_CAP_MS = conf(
    "spark.rapids.shuffle.fetch.backoff.capMs", 2000.0,
    "Upper bound on a single fetch-retry backoff sleep.")
SHUFFLE_RECOVERY_ENABLED = conf(
    "spark.rapids.shuffle.recovery.enabled", True,
    "Recover from shuffle fetch failures instead of failing the query: "
    "a FetchFailedError at the reduce side invalidates the failed "
    "peer's map outputs (per-shuffle epoch bump), recomputes only the "
    "lost map tasks from the exchange's retained lineage, and retries "
    "the reduce — the role Spark's DAG scheduler plays for the "
    "reference's FetchFailedException.")
SHUFFLE_RECOVERY_MAX_STAGE_ATTEMPTS = conf(
    "spark.rapids.shuffle.recovery.maxStageAttempts", 4,
    "Bounded stage retries: how many times a reduce partition may be "
    "attempted (initial try + recoveries) before the query fails with "
    "a descriptive FetchFailedError — never a hang, never a partial "
    "result (Spark's spark.stage.maxConsecutiveAttempts analog).")
SHUFFLE_BLACKLIST_THRESHOLD = conf(
    "spark.rapids.shuffle.recovery.blacklist.failureThreshold", 3,
    "Consecutive recovery-attributed failures after which a peer "
    "address is blacklisted: readers route around it via the "
    "MapStatus's alternate address and map tasks stop being placed on "
    "it, instead of waiting out its full timeout every stage.")
SHUFFLE_BLACKLIST_DECAY_S = conf(
    "spark.rapids.shuffle.recovery.blacklist.decaySeconds", 30.0,
    "A blacklist entry expires after this long and the peer gets a "
    "fresh consecutive-failure budget — a recovered (flapping) "
    "executor rejoins service instead of being shunned forever.")
SHUFFLE_LOCAL_EXECUTORS = conf(
    "spark.rapids.shuffle.localExecutors", 1,
    "Number of in-process executor environments the manager-lane "
    "exchange spreads map tasks across (round-robin).  >1 makes map "
    "outputs genuinely remote to the reducing executor — loopback/TCP "
    "fetches, fault injection, and recovery all exercise multi-executor "
    "behavior in one process, like the reference's mocked-transport "
    "suites.  1 (default) keeps the single local manager.")
SHUFFLE_REPLICATION_FACTOR = conf(
    "spark.rapids.shuffle.replication.factor", 1,
    "Copies of each map output across in-process executors (1 = "
    "primary only, the default).  At 2+ the CachingShuffleWriter "
    "pushes each partition's serialized payload to factor-1 backup "
    "executors at write time: hedged fetches "
    "(spark.rapids.shuffle.hedge.enabled) can race a replica against "
    "a slow primary, and shuffle recovery promotes a live replica to "
    "primary on peer loss instead of recomputing from lineage "
    "(recompute remains the fallback when no replica survives).  "
    "Costs one extra serialization + host-store copy per replicated "
    "partition (replicatedBytes on the exchange's metrics).")
SHUFFLE_HEDGE_ENABLED = conf(
    "spark.rapids.shuffle.hedge.enabled", False,
    "Hedge slow shuffle fetches: when a remote fetch has not "
    "completed after the hedge delay (hedge.delayMs floor, or the "
    "hedge.quantile of recently observed fetch durations once enough "
    "samples exist), issue the same block request to a replica peer "
    "(shuffle.replication.factor >= 2) and keep the first complete, "
    "uncorrupted response — the loser is cancelled and its buffers "
    "freed.  "
    "First-wins is bit-exact: both attempts serve identical "
    "serialized payloads.")
SHUFFLE_HEDGE_DELAY_MS = conf(
    "spark.rapids.shuffle.hedge.delayMs", 1000.0,
    "Floor (and cold-start fallback) for the hedge trigger delay: a "
    "fetch outstanding this long fires the hedge even before enough "
    "latency samples exist to compute the quantile.")
SHUFFLE_HEDGE_QUANTILE = conf(
    "spark.rapids.shuffle.hedge.quantile", 0.95,
    "Latency quantile of recently completed fetches above which an "
    "outstanding fetch is considered straggling and hedged (once >= 8 "
    "samples exist; the effective delay is max(quantile latency, "
    "hedge.delayMs)).")

# --- expressions ------------------------------------------------------------
INCOMPATIBLE_OPS = conf(
    "spark.rapids.sql.incompatibleOps.enabled", False,
    "Enable operators producing results that differ slightly from Spark "
    "(the transcendental functions, whose last bit may differ from the "
    "JVM's).")
IMPROVED_FLOAT = conf(
    "spark.rapids.sql.improvedFloatOps.enabled", False,
    "Enable improved-precision float transcendental ops.  Declared with "
    "the reference's default; no operator of either package reads it.")
HAS_NANS = conf(
    "spark.rapids.sql.hasNans", True,
    "Assume floating point data may contain NaNs.  Declared with the "
    "reference's default; every operator handles NaN whatever its "
    "value.")
CASTS_FLOAT_TO_STRING = conf(
    "spark.rapids.sql.castFloatToString.enabled", False,
    "Enable the float->string cast (formatting may differ from Java's at "
    "extreme exponents).")
CASTS_STRING_TO_FLOAT = conf(
    "spark.rapids.sql.castStringToFloat.enabled", False,
    "Enable the string->float cast (the parse may differ by 1 ulp from "
    "Java's).")
CASTS_STRING_TO_TS = conf(
    "spark.rapids.sql.castStringToTimestamp.enabled", False,
    "Enable the string->timestamp cast (canonical forms only).")

# --- aggregation ------------------------------------------------------------
VARIABLE_FLOAT_AGG = conf(
    "spark.rapids.sql.variableFloatAgg.enabled", False,
    "Allow float aggregations whose result can vary with evaluation "
    "order.")
PALLAS_Q1_ENABLED = conf(
    "spark.rapids.tpu.pallas.q1.enabled", False,
    "Use the fused Q1 kernel for SINGLE-batch TPC-H Q1 steps "
    "(models.tpch.build_q1_kernel); off, the step is plain torch ops.")
DICT_GROUPBY_ENABLED = conf(
    "spark.rapids.tpu.dictGroupby.enabled", True,
    "Sort-free grouped aggregation through the grouped-sum kernel when "
    "the integral group keys' runtime range fits dictGroupby.maxGroups. "
    "Float Sum/Average additionally require variableFloatAgg.enabled "
    "(the kernel accumulates f32); integral inputs are exact or deopt.")
DICT_GROUPBY_MAX_GROUPS = conf(
    "spark.rapids.tpu.dictGroupby.maxGroups", 32768,
    "Max runtime key range (composite, for several keys) of the "
    "dictionary group-by fast path.")
BANDED_GROUPBY_ENABLED = conf(
    "spark.rapids.tpu.bandedGroupby.enabled", True,
    "Sum/Count/Average group-bys aggregate through the sorted-run "
    "window_group_sums kernel after the grouping sort. Accumulation is "
    "f32: integral measures are exact-or-deopt via the sum(|v|) "
    "certificate, float measures additionally require "
    "variableFloatAgg.enabled.")
HASH_GROUPING_ENABLED = conf(
    "spark.rapids.tpu.hashGrouping.enabled", True,
    "Wide grouping key sets sort by two murmur3-derived words instead of "
    "the lexicographic key encode (string keys emit one 9-bit slice per "
    "character).  Exact: segment boundaries come from the adjacent key "
    "values, and a detected 64-bit collision deopts the query to the "
    "lexicographic lane.")
PALLAS_Q1_FUSED_ENABLED = conf(
    "spark.rapids.tpu.pallas.q1Fused.enabled", True,
    "Use the fused Q1 kernel for STACKED multi-batch TPC-H Q1 steps "
    "(models.tpch.build_q1_fused_kernel); off, each batch runs the "
    "plain torch step.")


# --- I/O formats (the format enables and Spark's spark.sql.files.* split
# planning keys) --------------------------------------------------------------
PARQUET_ENABLED = conf("spark.rapids.sql.format.parquet.enabled", True,
                       "Enable parquet scan/write acceleration.")
PARQUET_READ_ENABLED = conf("spark.rapids.sql.format.parquet.read.enabled",
                            True, "Enable accelerated parquet reads.")
PARQUET_WRITE_ENABLED = conf("spark.rapids.sql.format.parquet.write.enabled",
                             True, "Enable accelerated parquet writes.")
ORC_ENABLED = conf("spark.rapids.sql.format.orc.enabled", True,
                   "Enable ORC scan/write acceleration.")
ORC_READ_ENABLED = conf("spark.rapids.sql.format.orc.read.enabled", True,
                        "Enable accelerated ORC reads.")
ORC_WRITE_ENABLED = conf("spark.rapids.sql.format.orc.write.enabled", True,
                         "Enable accelerated ORC writes.")
CSV_ENABLED = conf("spark.rapids.sql.format.csv.enabled", True,
                   "Enable CSV scan acceleration (reads only).")
CSV_READ_ENABLED = conf("spark.rapids.sql.format.csv.read.enabled", True,
                        "Enable accelerated CSV reads.")
MULTITHREAD_READ_NUM_THREADS = conf(
    "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads", 20,
    "Host file-buffering threads per executor (small-file optimization).")
MAX_PARTITION_BYTES = conf("spark.sql.files.maxPartitionBytes", 134217728,
                           "Max bytes packed into one scan partition.")
FILE_OPEN_COST = conf("spark.sql.files.openCostInBytes", 4194304,
                      "Estimated cost in bytes of opening a file when "
                      "packing splits into scan partitions.")
MIN_PARTITION_NUM = conf("spark.sql.files.minPartitionNum", 8,
                         "Suggested minimum scan partition count (Spark "
                         "defaults this to the cluster parallelism).")

# --- device and memory (memory/*) -------------------------------------------
CONCURRENT_TPU_TASKS = conf("spark.rapids.sql.concurrentGpuTasks", 1,
                            "Number of tasks that may hold the accelerator "
                            "concurrently (GpuSemaphore analog).")
HBM_ALLOC_FRACTION = conf("spark.rapids.memory.gpu.allocFraction", 0.9,
                          "Fraction of HBM to dedicate to the arena pool.")
HBM_RESERVE = conf("spark.rapids.memory.gpu.reserve", 1073741824,
                   "HBM bytes kept free for XLA scratch/fusion temporaries.")
HBM_BUDGET_BYTES = conf(
    "spark.rapids.memory.hbmBudgetBytes", 0,
    "Hard cap (bytes) on the accounted HBM arena budget, applied AFTER "
    "the allocFraction/reserve arithmetic: the effective budget is "
    "min(total*allocFraction - reserve, this).  0 (default) disables "
    "the cap.  This is the out-of-core lever: capping the budget below "
    "an operator's working set makes DeviceManager.try_reserve report "
    "no headroom, which routes sort/join/aggregate through their "
    "external (spill-backed) algorithms instead of split-retrying to "
    "the row floor — bounded-HBM execution on data larger than device "
    "memory.")
HBM_DEBUG = conf(
    "spark.rapids.memory.gpu.debug", "NONE",
    "Allocation debug logging: NONE, STDOUT, STDERR.  Declared with the "
    "reference's default; the port allocates through PyTorch's caching "
    "allocator and logs nothing for it.")
HOST_SPILL_STORAGE = conf("spark.rapids.memory.host.spillStorageSize",
                          1073741824, "Host memory for spilled device data.")
PINNED_POOL_SIZE = conf("spark.rapids.memory.pinnedPool.size", 0,
                        "Pinned host staging pool bytes (0 = disabled).")
RETRY_MIN_SPLIT_ROWS = conf(
    "spark.rapids.memory.retry.minSplitRows", 1024,
    "Floor for OOM split-and-retry: a batch at or below this many rows "
    "is not subdivided further; reservation failure there takes the "
    "retry.fallback path instead (memory/retry.py harness; the role of "
    "the reference's SplitAndRetryOOM minimum split size).")
RETRY_FALLBACK = conf(
    "spark.rapids.memory.retry.fallback", "bestEffort",
    "What happens when a batch at the minimum split size still cannot "
    "be reserved: bestEffort runs it unreserved (the accounted arena "
    "is advisory; a true device OOM surfaces as the allocator's own "
    "error), error fails the query with an actionable message.  Never "
    "a silent wrong answer.")
OOM_INJECT_RATE = conf(
    "spark.rapids.memory.faultInjection.oomRate", 0.0,
    "TEST ONLY: probability that a device-memory reservation is forced "
    "to fail, exercising the spill -> retry -> split-and-retry -> "
    "floor-fallback lattice on CPU CI without a real HBM-sized "
    "workload (the memory-layer sibling of the shuffle transport "
    "fault injector).  0 disables injection.")
OOM_INJECT_SEED = conf(
    "spark.rapids.memory.faultInjection.seed", 0,
    "Deterministic seed for OOM fault injection.")
OOM_INJECT_MAX = conf(
    "spark.rapids.memory.faultInjection.maxInjections", 1024,
    "Hard cap on injected reservation failures per injector lifetime, "
    "guaranteeing forward progress in soak loops even at oomRate=1.0 "
    "(0 = unlimited).")
SPILL_CORRUPT_RATE = conf(
    "spark.rapids.memory.faultInjection.spillCorruptRate", 0.0,
    "TEST ONLY: probability that a freshly written spill file has one "
    "payload byte flipped on disk (after the CRC frame was written), "
    "proving the disk re-read's integrity check surfaces "
    "SpillCorruptionError instead of deserializing garbage.  Seeded "
    "by faultInjection.seed.  0 disables.")
OOCORE_ENABLED = conf(
    "spark.rapids.memory.oocore.enabled", True,
    "Degrade gracefully to external algorithms when an operator's "
    "working set exceeds the HBM budget's headroom: sort spills sorted "
    "runs and k-way merges them back in budget-sized windows, hash "
    "join grace-partitions the build AND probe sides by key hash and "
    "joins partition pairs that fit, and hash aggregate spills partial "
    "group state and re-merges it.  Runs travel the existing "
    "device->host->disk spill tiers.  OOM split-and-retry remains the "
    "inner lattice; out-of-core is the outer ring engaged BEFORE the "
    "retry.fallback path.  Off: the pre-out-of-core behavior (split "
    "to minSplitRows, then bestEffort|error).")
OOCORE_WINDOW_FRACTION = conf(
    "spark.rapids.memory.oocore.windowFraction", 0.5,
    "Fraction of the HBM budget one operator may hold resident before "
    "degrading to its external algorithm — and the size of each merge "
    "window when it does.  The working-set estimate is real "
    "accounting (2x device batch bytes, the same estimate the OOM "
    "harness reserves with) judged against try_reserve headroom, not "
    "a guess.  Smaller values spill earlier and merge in more passes; "
    "larger values risk the inner retry lattice engaging first.")
OOCORE_GRACE_PARTITIONS = conf(
    "spark.rapids.memory.oocore.gracePartitions", 8,
    "Fan-out of one grace-hash partitioning pass: build and probe "
    "sides split into this many key-hash partitions, each joined "
    "independently (partition pairs are key-disjoint).  A partition "
    "whose build side still exceeds the window re-partitions "
    "recursively with a depth-salted hash, up to "
    "oocore.maxRecursionDepth.")
OOCORE_MAX_RECURSION = conf(
    "spark.rapids.memory.oocore.maxRecursionDepth", 4,
    "Bound on grace-hash re-partitioning recursion (and on external "
    "sort/aggregate re-spill rounds).  A partition that cannot be "
    "made to fit within this depth — pathological key skew, e.g. one "
    "key carrying the whole build side — fails with a descriptive "
    "error naming the skewed partition and the knobs, never a hang "
    "and never partial data.")
OOCORE_RUN_REPLICAS = conf(
    "spark.rapids.memory.oocore.runReplicas", 1,
    "Copies written per spilled run.  At 2+, a SpillCorruption on "
    "re-read (disk rot, faultInjection.spillCorruptRate) quarantines "
    "the corrupt buffer and recovers from a replica instead of "
    "failing the query (numSpillCorruptionsRecovered counts these); "
    "at 1 recovery needs a recompute closure or the corruption "
    "surfaces as the descriptive SpillCorruption error.  Replicas "
    "cost spill-tier capacity, not HBM.")


# --- query watchdog (utils/watchdog.py) --------------------------------------
WATCHDOG_ENABLED = conf(
    "spark.rapids.sql.watchdog.enabled", True,
    "Detect hung queries: every long-lived activity (prefetch "
    "producers, AQE stage fills, out-of-core merge passes, the first "
    "kernel build) registers a progress heartbeat; a scanner thread "
    "that sees no progress past the activity's deadline class emits "
    "one diagnostic dump and cancels the query cooperatively, raising "
    "a descriptive TpuQueryTimeout instead of hanging forever.")
WATCHDOG_POLL_INTERVAL = conf(
    "spark.rapids.sql.watchdog.pollInterval", 1.0,
    "Seconds between watchdog scans of registered heartbeats.  Bounds "
    "detection latency at deadline + pollInterval.")
WATCHDOG_TASK_TIMEOUT = conf(
    "spark.rapids.sql.watchdog.taskTimeout", 300.0,
    "Deadline (seconds) for task-class activities: prefetch producer "
    "loops, AQE stage fills, out-of-core merge passes, admission-queue "
    "waits.  An activity making no progress for this long is declared "
    "hung and the query is cancelled with a diagnostic dump.")
WATCHDOG_COLLECTIVE_TIMEOUT = conf(
    "spark.rapids.sql.watchdog.collectiveTimeout", 120.0,
    "Deadline (seconds) for collective-class activities (multi-device "
    "exchange dispatches; none in a one-card process yet).")
WATCHDOG_COMPILE_TIMEOUT = conf(
    "spark.rapids.sql.watchdog.compileTimeout", 600.0,
    "Deadline (seconds) for kernel builds: the nvcc runs of "
    "ops/cuda_build.py.")
WATCHDOG_DUMP_ON_TIMEOUT = conf(
    "spark.rapids.sql.watchdog.dumpOnTimeout", True,
    "Emit one diagnostic dump (all thread stacks, semaphore holders, "
    "scheduler and prefetch state, device memory, hang-injection "
    "state) when the watchdog declares a timeout; the dump rides on "
    "the raised TpuQueryTimeout and is logged at ERROR.")
HANG_INJECT_SITE = conf(
    "spark.rapids.memory.faultInjection.hangSite", "",
    "TEST ONLY: inject a hang at the named site so watchdog "
    "detection, cancellation and resource release are testable "
    "without a real wedge.  Sites: producer (prefetch producer loop), "
    "oocore-merge (an out-of-core merge pass), pyudf (a wedged Python "
    "UDF worker), compile (the first kernel build), collective (a mesh "
    "exchange round or SPMD gang dispatch).  The injected hang "
    "blocks until the query's CancelToken fires.  Empty disables.")
HANG_INJECT_AFTER = conf(
    "spark.rapids.memory.faultInjection.hangAfterBatches", 0,
    "TEST ONLY: the injected hang engages after this many units of "
    "progress (batches produced, merge groups, builds started) at the "
    "configured hangSite.")
SLOW_INJECT_SITE = conf(
    "spark.rapids.memory.faultInjection.slowSite", "",
    "TEST ONLY: inject a seeded, cancellable delay at the named site "
    "(the slow sibling of hangSite).  Empty disables.")
SLOW_INJECT_FACTOR = conf(
    "spark.rapids.memory.faultInjection.slowFactor", 0.0,
    "TEST ONLY: slowdown multiplier for slowSite: each unit of work "
    "sleeps (slowFactor - 1) x slowUnitMs.  <= 1 disables.")
SLOW_INJECT_SEED = conf(
    "spark.rapids.memory.faultInjection.slowSeed", 0,
    "TEST ONLY: seed for the slow injector's +/-25% delay jitter.")
SLOW_INJECT_VICTIM = conf(
    "spark.rapids.memory.faultInjection.slowVictim", "",
    "TEST ONLY: executor id the slow injector targets; empty slows "
    "every caller that reaches the site.")
SLOW_INJECT_UNIT_MS = conf(
    "spark.rapids.memory.faultInjection.slowUnitMs", 20.0,
    "TEST ONLY: nominal per-unit work time (ms) the slowFactor "
    "multiplies.")

# --- query profiles (utils/profile.py) ---------------------------------------
PROFILE_ENABLED = conf(
    "spark.rapids.sql.profile.enabled", False,
    "Record a per-query observability profile: a span tree (query -> "
    "stage/exchange -> operator -> batch/compile/shuffle-fetch/retry) "
    "with thread-propagated parenting, each span also pushed as an NVTX "
    "range on a CUDA query (torch.profiler.record_function on the CPU) so "
    "profiler captures line up, plus a structured event log (retries, "
    "fetch failures, blacklists, watchdog dumps, cancellations — all "
    "carrying the query id).  On collect() the spans, events, an "
    "EXPLAIN-with-metrics plan report, and a wall-clock breakdown "
    "(compute vs pipeline wait vs shuffle vs compile vs retry-block) "
    "assemble into a QueryProfile kept in a bounded history.  Disabled "
    "(default) the batch hot loop allocates no tracer objects.")
PROFILE_HISTORY_SIZE = conf(
    "spark.rapids.sql.profile.historySize", 16,
    "How many completed QueryProfiles to retain in the in-process "
    "history (utils.profile.profile_history), queryable from tests and "
    "bench harnesses.  Oldest profiles are dropped first.")
PROFILE_EVENT_LOG_PATH = conf(
    "spark.rapids.sql.profile.eventLog.path", "",
    "When set, every profiled query appends its structured event "
    "records (span open/close, retries, fetch failures, blacklists, "
    "watchdog dumps, cancellations) to this file as JSON lines, each "
    "carrying the query id.  Empty disables the file sink; the "
    "in-process QueryProfile.events view is always available.")
PROFILE_CHROME_TRACE_PATH = conf(
    "spark.rapids.sql.profile.chromeTrace.path", "",
    "When set, every profiled query writes its span tree to this path "
    "as Chrome trace-event JSON (loadable in Perfetto / "
    "chrome://tracing).  A '{query_id}' placeholder in the path is "
    "substituted so consecutive queries do not overwrite each other.  "
    "Empty disables the file sink; QueryProfile.chrome_trace() always "
    "serves the same payload in-process.")
MOVEMENT_ENABLED = conf(
    "spark.rapids.sql.profile.movement.enabled", True,
    "When profiling is on, additionally record the per-query "
    "data-movement ledger (utils/movement.py): bytes + duration on "
    "every edge where data crosses a boundary — host->device uploads, "
    "device->host readbacks, spill tier migrations, shuffle wire "
    "bytes (compressed AND uncompressed), and collective payloads.  "
    "The QueryProfile then carries a movement report (per-edge totals, "
    "effective GB/s vs roofline, compression ratios), Chrome-trace "
    "counter tracks, and data_movement event records.  Off: the "
    "profiler records time only.")
MOVEMENT_ROOFLINE_GBPS = conf(
    "spark.rapids.sql.profile.movement.rooflineGBps", 0.0,
    "Bandwidth ceiling (GB/s) the movement report computes "
    "utilization against, for every edge.  0 (default) resolves the "
    "per-edge ceilings through the shared roofline table "
    "(spark.rapids.sql.profile.roofline.*, utils/roofline.py — the "
    "same source kernelprof judges kernels against); a non-zero "
    "value overrides ALL edges at once, e.g. with a probed number.")
MOVEMENT_MIN_EVENT_BYTES = conf(
    "spark.rapids.sql.profile.movement.minEventBytes", 65536,
    "Movement records at or above this many bytes also land in the "
    "structured event log as data_movement records (correlatable with "
    "retries, fetch failures, and watchdog dumps by query id); "
    "smaller records are aggregated into the ledger only, keeping the "
    "event ring for interesting transfers.  0 logs every record.")
RESIDENCY_ENABLED = conf(
    "spark.rapids.sql.profile.residency.enabled", True,
    "When profiling is on, additionally run the device-memory residency "
    "ledger (utils/residency.py): every tracked device-resident "
    "allocation — tiered-store buffers (including shuffle catalog "
    "buffers) and OOM-harness reservations — registers per-buffer "
    "provenance (query id, operator site, size, tier) on creation and "
    "retires it on free/spill.  Profiled queries get a '-- residency --' "
    "section (high-water mark, peak-instant composition by site/tier, "
    "leak verdict), Perfetto residency:<site> counter tracks, and an "
    "end-of-query leak check that dumps still-resident buffers with "
    "provenance; the slow-query log aggregates observed high-water "
    "marks per plan fingerprint and telemetry exports "
    "hbm_resident_bytes{tier} plus per-site gauges.  Tracking is "
    "process-sticky once the first residency-enabled query runs; off "
    "(default until then) every hook is one global read and allocates "
    "nothing.")
RESIDENCY_TIMELINE_SIZE = conf(
    "spark.rapids.sql.profile.residency.timelineSize", 4096,
    "Bound on per-query residency timeline samples (one per tracked "
    "alloc/free) backing the Perfetto residency:<site> counter "
    "tracks; oldest samples are dropped first.  The high-water mark "
    "and peak composition are exact regardless of this bound.")
RESIDENCY_LEAK_DUMP = conf(
    "spark.rapids.sql.profile.residency.leakDump", 8,
    "How many leaked buffers (still resident at query end) the "
    "residency report and event log render with full provenance "
    "(site, tier, kind, size, age); the leak COUNT is always exact.")
KERNELPROF_ENABLED = conf(
    "spark.rapids.sql.profile.kernels.enabled", False,
    "Per-kernel performance attribution (utils/kernelprof.py): every "
    "device step at a kernel-cache site of the reference and every "
    "hand-written CUDA kernel launch is counted in a process-wide "
    "catalog, and a sampled fraction is timed with a pair of CUDA "
    "events on the current stream (resolved at query end, so sampling "
    "adds no host sync per launch) and joined with the step's analytic "
    "cost (bytes of its inputs and outputs; FLOPs for the hand "
    "kernels) into achieved GFLOP/s and GB/s vs the conf-overridable "
    "roofline table (spark.rapids.sql.profile.roofline.*).  Profiled "
    "queries additionally get a '-- kernels --' section in their "
    "QueryProfile plus Perfetto kernel tracks, and the slow-query log "
    "names each fingerprint's hottest kernel.  Off (default): one "
    "global read per step, bit-exact.")
KERNELPROF_SAMPLE_RATE = conf(
    "spark.rapids.sql.profile.kernels.sampleRate", 8,
    "Time every Nth entry of each kernel (1 = every entry) with a pair "
    "of CUDA events; unsampled entries are estimated by scaling the "
    "sampled mean.  The events are read at query end, so a lower rate "
    "costs event records on the stream, not host syncs.")
KERNELPROF_COST_ANALYSIS = conf(
    "spark.rapids.sql.profile.kernels.costAnalysis", True,
    "Capture each kernel's analytic cost (bytes read and written; "
    "FLOPs for the hand kernels) once, at its first entry, enabling "
    "the achieved-GFLOP/s / GB/s roofline join; off keeps timing-only "
    "attribution.")
KERNELPROF_TOP_N = conf(
    "spark.rapids.sql.profile.kernels.topN", 12,
    "How many kernels (by cumulative attributed device time) the "
    "QueryProfile's '-- kernels --' section renders; the full "
    "per-fingerprint table stays queryable via "
    "QueryProfile.kernels and utils.kernelprof.catalog().")

# --- shared roofline table (utils/roofline.py) --------------------------------
# ONE conf-overridable source for every bandwidth/compute ceiling the
# instruments judge against.  Defaults are NVIDIA H100 SXM5 datasheet
# figures.
ROOFLINE_UPLOAD_GBPS = conf(
    "spark.rapids.sql.profile.roofline.uploadGBps", 64.0,
    "Nominal host->device bandwidth ceiling (GB/s) for the movement "
    "report's upload edge; the default is the H100 SXM5 datasheet's "
    "host interface, PCIe Gen5 x16 (128 GB/s both ways), per "
    "direction.")
ROOFLINE_READBACK_GBPS = conf(
    "spark.rapids.sql.profile.roofline.readbackGBps", 64.0,
    "Nominal device->host bandwidth ceiling (GB/s) for the movement "
    "report's readback edge; the default is the H100 SXM5 datasheet's "
    "PCIe Gen5 x16 line, per direction.")
ROOFLINE_SPILL_GBPS = conf(
    "spark.rapids.sql.profile.roofline.spillGBps", 64.0,
    "Nominal bandwidth ceiling (GB/s) for spill tier migrations "
    "(device->host->disk hops share the host link); the default is the "
    "H100 SXM5 datasheet's PCIe Gen5 x16 line, per direction.")
ROOFLINE_WIRE_GBPS = conf(
    "spark.rapids.sql.profile.roofline.wireGBps", 12.5,
    "Nominal shuffle-wire bandwidth ceiling (GB/s); the default models "
    "a 100 Gb/s NIC (not a line of the card's datasheet).")
ROOFLINE_COLLECTIVE_GBPS = conf(
    "spark.rapids.sql.profile.roofline.collectiveGBps", 450.0,
    "Nominal collective bandwidth ceiling (GB/s); the default is the "
    "H100 SXM5 datasheet's NVLink line (900 GB/s), per direction.")
ROOFLINE_HBM_GBPS = conf(
    "spark.rapids.sql.profile.roofline.hbmGBps", 3350.0,
    "Device-memory bandwidth ceiling (GB/s) kernelprof judges each "
    "kernel's achieved GB/s (analytic bytes / device time) against; "
    "the default is the H100 SXM5 datasheet's GPU memory bandwidth "
    "line (3.35 TB/s, HBM3).")
ROOFLINE_PEAK_GFLOPS = conf(
    "spark.rapids.sql.profile.roofline.peakGflops", 66900.0,
    "Compute ceiling (GFLOP/s) kernelprof judges each kernel's "
    "achieved GFLOP/s against; the default is the H100 SXM5 "
    "datasheet's FP32 line (67 TFLOP/s on CUDA cores): the engine's "
    "kernels add in f32/f64 and use no tensor cores.  A kernel's "
    "roofline utilization is the max of its compute fraction and its "
    "memory-bandwidth fraction — whichever resource binds.")

PROFILE_EVENT_LOG_MAX_BYTES = conf(
    "spark.rapids.sql.profile.eventLog.maxBytes", 134217728,
    "Size-based rotation bound for the profile event-log JSONL sink "
    "(and the telemetry snapshot records riding it): when an append "
    "would push the file past this many bytes it is rotated to "
    "<path>.1 (older rotations shift to .2, .3, ...).  0 disables "
    "rotation.")
PROFILE_EVENT_LOG_KEEP_FILES = conf(
    "spark.rapids.sql.profile.eventLog.keepFiles", 4,
    "How many rotated event-log files (<path>.1 .. <path>.N) to "
    "retain; the oldest is dropped at each rotation.  0 discards the "
    "full file at rotation instead of keeping any history.")

# --- engine-wide telemetry (utils/telemetry.py) -------------------------------
TELEMETRY_ENABLED = conf(
    "spark.rapids.sql.telemetry.enabled", False,
    "Run the process-wide telemetry layer: a live metrics registry "
    "(device budget/in-use and the admission ledger, semaphore "
    "holds/waiters, scheduler queue depth and admission counters, "
    "prefetch hits/stalls, in-flight shuffle fetches, "
    "speculation/recovery counters, spill tier sizes, cumulative "
    "data-movement edge bytes) plus a low-rate background sampler that "
    "builds a device-utilization timeline — each sample attributed to "
    "busy-compute or a named idle cause (queue wait, semaphore wait, "
    "pipeline stall, host sync, compile, shuffle wait, truly idle).  "
    "Surfaced as a Prometheus text endpoint (telemetry.port), periodic "
    "JSONL snapshots on the profile event-log sink, and a slow-query "
    "log aggregated by plan fingerprint.  Disabled (default) every "
    "hook is a single module-global read and allocates nothing.")
TELEMETRY_PORT = conf(
    "spark.rapids.sql.telemetry.port", 0,
    "TCP port for the opt-in HTTP exporter (binds 127.0.0.1): GET "
    "/metrics serves Prometheus text exposition format, GET "
    "/telemetry a JSON snapshot (gauges + utilization summary + "
    "slow-query log).  0 (default) starts no server; the in-process "
    "views (utils.telemetry.prometheus_text / snapshot) are always "
    "available while telemetry is enabled.")
TELEMETRY_SAMPLE_PERIOD_MS = conf(
    "spark.rapids.sql.telemetry.samplePeriodMs", 100.0,
    "Period of the utilization sampler: each tick attributes the "
    "instant to busy-compute or a named idle cause using the "
    "already-instrumented heartbeats, semaphore, scheduler queue, "
    "prefetch queues, and in-flight fetches.")
TELEMETRY_TIMELINE_SIZE = conf(
    "spark.rapids.sql.telemetry.timelineSize", 4096,
    "Bound on retained utilization-timeline samples (a ring buffer; "
    "cause PERCENTAGES aggregate over the whole process lifetime "
    "regardless).")
TELEMETRY_SNAPSHOT_PERIOD_S = conf(
    "spark.rapids.sql.telemetry.snapshotPeriodS", 10.0,
    "Period of the JSONL telemetry snapshots (gauges + utilization "
    "summary) appended to the profile event-log sink "
    "(spark.rapids.sql.profile.eventLog.path) with kind="
    "'telemetry_snapshot'.  0 disables periodic snapshots; snapshots "
    "also require the event-log path to be set.")
TELEMETRY_SLOW_QUERY_LOG_SIZE = conf(
    "spark.rapids.sql.telemetry.slowQueryLog.size", 64,
    "How many distinct plan fingerprints the slow-query log retains "
    "(least-recently-updated dropped first).  Each entry aggregates "
    "the completed QueryProfiles of one plan shape: run count, "
    "p50/p95/max wall clock, and the top idle cause from the "
    "wall-clock breakdown.  Requires spark.rapids.sql.profile.enabled "
    "on the queries to be aggregated.")

# --- concurrent multi-query serving (exec/scheduler.py) ----------------------
SCHED_ENABLED = conf(
    "spark.rapids.sql.scheduler.enabled", True,
    "Admission-control concurrent queries against the accounted device "
    "memory budget: each top-level collect declares a budget estimate "
    "(scheduler.queryBudgetBytes) and is admitted only while the sum "
    "of admitted budgets fits the device budget and fewer than "
    "scheduler.maxConcurrentQueries queries are in flight; otherwise "
    "it waits FIFO in a bounded queue and is shed with a descriptive "
    "TpuQueryRejected when the queue is full.")
SCHED_MAX_CONCURRENT = conf(
    "spark.rapids.sql.scheduler.maxConcurrentQueries", 4,
    "Cap on concurrently ADMITTED queries per process.  Also the "
    "divisor for the default per-query budget when queryBudgetBytes "
    "is 0.")
SCHED_QUERY_BUDGET = conf(
    "spark.rapids.sql.scheduler.queryBudgetBytes", 0,
    "Device bytes a query declares at admission, charged against the "
    "DeviceManager admission ledger for the query's lifetime.  0 "
    "derives an equal share: device budget / maxConcurrentQueries.")
SCHED_QUEUE_DEPTH = conf(
    "spark.rapids.sql.scheduler.queueDepth", 32,
    "Bound on queries waiting in the admission queue.  A query "
    "arriving at a full queue is rejected with TpuQueryRejected.")
SCHED_QUEUE_TIMEOUT = conf(
    "spark.rapids.sql.scheduler.queueTimeout", 120.0,
    "Seconds a query may wait in the admission queue before it is "
    "shed with TpuQueryRejected.")
RESULT_CACHE_ENABLED = conf(
    "spark.rapids.sql.scheduler.resultCache.enabled", False,
    "Cache collected query results keyed by (plan structural "
    "fingerprint, source-data identity, session-conf fingerprint): a "
    "hit returns the cached result bit-exactly without touching the "
    "device.  Off by default: in-memory sources are keyed by object "
    "identity, so callers that mutate source data in place must leave "
    "this off.")
RESULT_CACHE_MAX_BYTES = conf(
    "spark.rapids.sql.scheduler.resultCache.maxBytes", 268435456,
    "Byte bound on the result cache (LRU eviction; host memory).  A "
    "single result larger than this is never cached.")

# --- speculative partition execution (exec/speculation.py) -------------------
SPECULATION_ENABLED = conf(
    "spark.rapids.sql.speculation.enabled", False,
    "Launch duplicate attempts of straggling manager-lane map tasks "
    "(spark.rapids.shuffle.enabled with localExecutors >= 2): a task "
    "running far past its stage's completed-task median (a *slow* "
    "watchdog classification, distinct from *hung*) is re-executed "
    "from the exchange's retained lineage on another in-process "
    "executor; whichever attempt commits its map output first wins "
    "and the loser is cancelled via its per-attempt CancelToken.  "
    "First-wins commit is epoch-guarded in the MapOutputRegistry, so "
    "a losing attempt can never publish — results stay bit-exact.  "
    "The p95/p99 lever for one degraded executor; speculation never "
    "fires on a healthy stage.")
SPECULATION_MULTIPLIER = conf(
    "spark.rapids.sql.speculation.multiplier", 3.0,
    "How many times slower than the stage's completed-task median a "
    "running task must be before a speculative duplicate launches "
    "(spark.speculation.multiplier analog).")
SPECULATION_MIN_RUNTIME_MS = conf(
    "spark.rapids.sql.speculation.minTaskRuntimeMs", 100.0,
    "A task is never speculated before running at least this long — "
    "guards against duplicating every task of a stage whose median is "
    "microseconds.")
SPECULATION_MIN_COMPLETED = conf(
    "spark.rapids.sql.speculation.minCompletedTasks", 2,
    "Completed tasks the stage needs before its median is trusted for "
    "slow classification (spark.speculation.quantile analog: no "
    "speculation while the baseline is unknown).")

# --- async pipelined execution (exec/pipeline.py) ----------------------------
PIPELINE_ENABLED = conf(
    "spark.rapids.sql.pipeline.enabled", True,
    "Overlap pipeline stages with bounded background prefetch: at "
    "pipeline breaks (scan->compute, both sides of a shuffle exchange, "
    "coalesce boundaries, AQE stage materialization) a producer thread "
    "runs the upstream iterator prefetchDepth batches ahead while the "
    "consumer computes.  Producers enqueue on their creator's CUDA "
    "stream, and one blocked on a full queue never holds the "
    "semaphore.")
PIPELINE_PREFETCH_DEPTH = conf(
    "spark.rapids.sql.pipeline.prefetchDepth", 2,
    "How many batches a pipeline producer may run ahead of its "
    "consumer at each pipeline break.  Bounds peak device memory at "
    "~depth extra batches per break; 0 disables prefetch.")

# --- adaptive query execution and broadcast joins (plan/aqe.py) -------------
ADAPTIVE_ENABLED = conf(
    "spark.sql.adaptive.enabled", False,
    "Re-plan at query-stage boundaries from runtime shuffle statistics.")
COALESCE_PARTITIONS_ENABLED = conf(
    "spark.sql.adaptive.coalescePartitions.enabled", True,
    "Merge adjacent small reduce partitions after a shuffle stage.")
ADVISORY_PARTITION_SIZE = conf(
    "spark.sql.adaptive.advisoryPartitionSizeInBytes", 64 * 1024 * 1024,
    "Target post-shuffle partition size for AQE partition coalescing.")
AUTO_BROADCAST_THRESHOLD = conf(
    "spark.sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Max build-side bytes for the AQE shuffled-hash-join to "
    "broadcast-join demotion (-1 disables).")
BROADCAST_TIMEOUT = conf(
    "spark.sql.broadcastTimeout", 300,
    "Seconds allowed for materializing a broadcast build side before "
    "the exchange fails.")
MAX_BROADCAST_TABLE_BYTES = conf(
    "spark.rapids.tpu.maxBroadcastTableBytes", 8 << 30,
    "Hard cap on a broadcast build side's device bytes; exceeding it "
    "fails the query with a clear error instead of exhausting device "
    "memory (Spark's 8GB broadcast-table limit).")

KERNEL_CACHE_MAX_ENTRIES = conf(
    "spark.rapids.sql.kernelCache.maxEntries", 512,
    "Entry bound of the reference's compiled-kernel cache.  Declared so "
    "one conf drives both packages; the port runs eagerly and has no "
    "kernel cache, so there is nothing for it to bound.")
METRICS_LEVEL = conf(
    "spark.rapids.sql.metrics.level", "MODERATE",
    "Operator metric detail: ESSENTIAL, MODERATE, DEBUG.  Declared with "
    "the reference's default; every metric is collected whatever its "
    "value.")

# --- Python UDFs (udf/, pyudf/) ----------------------------------------------
UDF_COMPILER_ENABLED = conf(
    "spark.rapids.sql.udfCompiler.enabled", True,
    "Compile Python UDF bytecode to expressions that run on the card.")
PYTHON_CONCURRENT_WORKERS = conf(
    "spark.rapids.python.concurrentPythonWorkers", 0,
    "Cap on concurrent Python UDF evaluations, and on the daemon's "
    "worker processes (0 = unlimited; the daemon then takes one worker "
    "per CPU core).")
PYTHON_DAEMON_ENABLED = conf(
    "spark.rapids.python.daemon.enabled", False,
    "Run vectorized Python UDFs in out-of-process daemon workers (Arrow "
    "IPC over pipes) instead of in-process: process isolation at one "
    "host round trip of cost (reference python/rapids/daemon.py).")
PYTHON_ON_TPU = conf(
    "spark.rapids.python.onTpu.enabled", False,
    "Let daemon UDF workers see the card.  Off by default: a worker "
    "starts with CUDA_VISIBLE_DEVICES empty, so it can make no CUDA "
    "context and takes no device memory from the executor (the "
    "reference's RAPIDS_PYTHON_ENABLED gate, python/rapids/worker.py).")
PYTHON_MEM_LIMIT = conf(
    "spark.rapids.python.memory.limitBytes", 0,
    "Address-space rlimit (RLIMIT_AS) per daemon UDF worker, 0 = "
    "unlimited (the role of the reference's per-worker RMM pool size). "
    "A worker allowed on the card with a limit below what CUDA maps at "
    "initialization fails its first CUDA call.")


def op_enable_key(kind: str, name: str) -> str:
    """Per-operator enable key ("expression" or "exec" kind)."""
    return f"spark.rapids.sql.{kind}.{name}"


class RapidsConf:
    """Immutable snapshot of config values."""

    def __init__(self, settings: Optional[dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def is_op_enabled(self, kind: str, name: str,
                      default: bool = True) -> bool:
        return _bool(self.get(op_enable_key(kind, name), default))

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._settings:
            val = self._settings[key]
            entry = _REGISTRY.get(key)
            if entry is not None and isinstance(val, str):
                return entry.converter(val)
            return val
        entry = _REGISTRY.get(key)
        if entry is not None:
            return entry.default
        return default

    def __getitem__(self, entry: ConfEntry) -> Any:
        return self.get(entry.key, entry.default)

    def is_set(self, key: str) -> bool:
        """True when `key` was given explicitly (not a default)."""
        return key in self._settings

    def fingerprint(self) -> tuple:
        """Hashable identity of every explicit setting: the result
        cache's conf component, so two sessions differing in any setting
        never serve each other's cached results."""
        return tuple(sorted((k, repr(v)) for k, v in self._settings.items()))

    def set(self, key: str, value: Any) -> "RapidsConf":
        """A copy with `key` set to `value`."""
        s = dict(self._settings)
        s[key] = value
        return RapidsConf(s)


_active = threading.local()


def get_active_conf() -> RapidsConf:
    """This thread's session conf; a thread with none that works for a
    query (a prefetch producer, an AQE stage fill) reads that query's
    conf snapshot, never the defaults."""
    c = getattr(_active, "conf", None)
    if c is None:
        from spark_rapids_tpu_torch.exec import scheduler as S
        qc = S.current()
        if qc is not None:
            return qc.conf
        c = RapidsConf()
        _active.conf = c
    return c


def set_active_conf(conf_: RapidsConf) -> None:
    _active.conf = conf_


@contextmanager
def session(conf_: Optional[RapidsConf]):
    """Install `conf_` as this thread's active conf for the duration."""
    if conf_ is None:
        yield
        return
    prev = getattr(_active, "conf", None)
    _active.conf = conf_
    try:
        yield
    finally:
        _active.conf = prev
