"""Common file-scan infrastructure (port of spark_rapids_tpu/io/scan.py).

  - `FileSplit`/`plan_file_partitions`: Spark's FilePartition bin-packing
    (the maxSplitBytes formula).
  - `discover_files`: hive-style partition-value discovery (key=value
    directories), the input Spark's catalog provides.
  - `append_partition_values`: per-batch partition-value columns.
  - `MultiFileCoalescingReader`: decodes a partition's splits on a host
    thread pool and coalesces the decoded tables into device batches.

The device boundary: all host parsing and decoding runs before the task
takes the device semaphore; only the upload to the device holds it.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import threading
import time
from typing import Any, Iterator, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import ColumnVector


@dataclasses.dataclass(frozen=True)
class FileSplit:
    """A byte range of one file plus its hive partition values."""
    path: str
    start: int
    length: int
    file_size: int
    partition_values: tuple[tuple[str, Any], ...] = ()


@dataclasses.dataclass(frozen=True)
class FilePartition:
    """One task's worth of splits (Spark's FilePartition)."""
    index: int
    splits: tuple[FileSplit, ...]


def plan_file_partitions(files: Sequence[FileSplit],
                         max_partition_bytes: int,
                         open_cost_bytes: int,
                         min_partitions: int = 1,
                         split_files: bool = True) -> list[FilePartition]:
    """Spark's split packing: split each file at maxSplitBytes, sort the
    splits by size, descending, and fill partitions of maxSplitBytes in
    order (each split costs its length plus the open cost).
    `split_files=False` packs whole files only (Databricks)."""
    total = sum(f.length for f in files) + open_cost_bytes * len(files)
    bytes_per_core = max(1, total // max(1, min_partitions))
    max_split = min(max_partition_bytes, max(open_cost_bytes,
                                             bytes_per_core))
    splits: list[FileSplit] = []
    for f in files:
        if not split_files:
            splits.append(f)
            continue
        off = f.start
        remaining = f.length
        while remaining > 0:
            size = min(max_split, remaining)
            splits.append(dataclasses.replace(f, start=off, length=size))
            off += size
            remaining -= size
    splits.sort(key=lambda s: s.length, reverse=True)
    partitions: list[list[FileSplit]] = []
    cur: list[FileSplit] = []
    cur_size = 0
    for s in splits:
        # Spark's rule: close on length overflow, but count the open
        # cost in the accumulated size
        if cur and cur_size + s.length > max_split:
            partitions.append(cur)
            cur, cur_size = [], 0
        cur.append(s)
        cur_size += s.length + open_cost_bytes
    if cur:
        partitions.append(cur)
    if not partitions:
        partitions = [[]]
    return [FilePartition(i, tuple(p)) for i, p in enumerate(partitions)]


# ---------------------------------------------------------------------------
# hive-style partition discovery
def discover_files(path: str, extension: Optional[str] = None
                   ) -> tuple[list[FileSplit], T.Schema]:
    """Walk `path`; parse key=value directory components into partition
    values.  Returns (files, partition_schema).  A partition column is
    INT64 when every value parses as an integer, else STRING (Spark's
    default inference)."""
    files: list[tuple[str, int, tuple[tuple[str, str], ...]]] = []
    if os.path.isfile(path):
        files.append((path, os.path.getsize(path), ()))
    else:
        for root, dirs, names in os.walk(path):
            dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
            rel = os.path.relpath(root, path)
            pvals = []
            if rel != ".":
                for comp in rel.split(os.sep):
                    if "=" in comp:
                        k, v = comp.split("=", 1)
                        pvals.append((k, v))
            for name in sorted(names):
                if name.startswith(("_", ".")):
                    continue
                if extension and not name.endswith(extension):
                    continue
                full = os.path.join(root, name)
                files.append((full, os.path.getsize(full), tuple(pvals)))
    part_names: list[str] = []
    for _, _, pvals in files:
        for k, _ in pvals:
            if k not in part_names:
                part_names.append(k)
    inferred: dict[str, T.DataType] = {}
    for k in part_names:
        vals = [dict(pv).get(k) for _, _, pv in files]
        inferred[k] = _infer_partition_type([v for v in vals if v is not None])
    typed_files = []
    for fpath, fsize, pvals in files:
        d = dict(pvals)
        typed = tuple((k, _convert_partition_value(d.get(k), inferred[k]))
                      for k in part_names)
        typed_files.append(FileSplit(fpath, 0, fsize, fsize, typed))
    return typed_files, T.Schema(tuple(T.Field(k, inferred[k])
                                       for k in part_names))


def _infer_partition_type(raw: list[str]) -> T.DataType:
    try:
        for v in raw:
            int(v)
        return T.INT64
    except (TypeError, ValueError):
        return T.STRING


def _convert_partition_value(raw: Optional[str], dt: T.DataType):
    if raw is None or raw == "__HIVE_DEFAULT_PARTITION__":
        return None
    if dt == T.INT64:
        return int(raw)
    return raw


def append_partition_values(batch: ColumnarBatch,
                            part_schema: T.Schema,
                            values: tuple[tuple[str, Any], ...]
                            ) -> ColumnarBatch:
    """Widen a data batch with constant partition-value columns."""
    if not len(part_schema):
        return batch
    vals = dict(values)
    cols = list(batch.columns)
    fields = list(batch.schema.fields)
    for f in part_schema.fields:
        cols.append(ColumnVector.from_scalar(
            vals.get(f.name), f.dtype, batch.capacity, batch.num_rows,
            device=batch.device))
        fields.append(f)
    return ColumnarBatch(T.Schema(tuple(fields)), cols, batch.num_rows)


# ---------------------------------------------------------------------------
class ChunkCounts:
    """Row groups (parquet) or stripes (ORC) a format's reads kept
    against those their splits held, summed over the pool's threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.read = 0
        self.total = 0

    def add(self, read: int, total: int) -> None:
        with self._lock:
            self.read += read
            self.total += total


class FormatReader:
    """Per-format host decode: split -> pyarrow Table (or None when the
    split prunes to nothing).  Implementations must be thread-safe; they
    run on the buffering pool."""

    #: file extension used by partition discovery
    extension: Optional[str] = None
    #: the format's ChunkCounts, where it has chunks to prune
    counts: Optional[ChunkCounts] = None

    def read_split(self, split: FileSplit, read_schema: T.Schema,
                   filter_expr) -> Optional["object"]:
        raise NotImplementedError

    def file_schema(self, path: str) -> T.Schema:
        raise NotImplementedError

    def resolve_session(self, conf: C.RapidsConf) -> "FormatReader":
        """Freeze conf-dependent reader state before dispatch to the
        buffering pool (the active conf is thread-local and does not
        reach pool threads).  Default: nothing to freeze."""
        return self


_POOL_LOCK = threading.Lock()
_POOLS: dict[int, concurrent.futures.ThreadPoolExecutor] = {}


def _buffering_pool(num_threads: int):
    """The process's host-read pool of `num_threads` threads (one pool per
    executor, sized by conf).  Pools live as long as the process: readers
    may hold them, and a session has one configured size."""
    with _POOL_LOCK:
        pool = _POOLS.get(num_threads)
        if pool is None:
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=num_threads,
                thread_name_prefix="gpu-file-buffer")
            _POOLS[num_threads] = pool
        return pool


class MultiFileCoalescingReader:
    """Reads a partition's splits on the buffering pool and coalesces the
    decoded host tables into device batches capped by the reader batch
    limits.  The semaphore is taken only around the upload."""

    def __init__(self, reader: FormatReader, partition: FilePartition,
                 read_schema: T.Schema, part_schema: T.Schema,
                 filter_expr, conf: C.RapidsConf, device, metrics=None):
        self.reader = reader.resolve_session(conf)
        self.partition = partition
        self.read_schema = read_schema
        self.part_schema = part_schema
        self.filter_expr = filter_expr
        self.conf = conf
        self.device = device
        self.metrics = metrics

    def __iter__(self) -> Iterator[ColumnarBatch]:
        num_threads = self.conf[C.MULTITHREAD_READ_NUM_THREADS]
        max_rows = min(self.conf[C.MAX_READER_BATCH_ROWS],
                       self.conf[C.MAX_BATCH_ROWS])
        max_bytes = self.conf[C.MAX_READER_BATCH_BYTES]
        pool = _buffering_pool(num_threads)
        t0 = time.perf_counter_ns()
        # a bounded window in flight: decoded tables are consumed in
        # split order, so about twice the pool's width is buffered
        window = max(2, num_threads * 2)
        splits = list(self.partition.splits)
        futures: collections.deque = collections.deque()
        next_submit = 0

        def top_up():
            nonlocal next_submit
            while next_submit < len(splits) and len(futures) < window:
                futures.append(pool.submit(
                    self.reader.read_split, splits[next_submit],
                    self.read_schema, self.filter_expr))
                next_submit += 1

        top_up()
        # tables accumulate per partition-value group and flush when the
        # next one would pass the reader batch limits
        pending: list = []
        pending_rows = 0
        pending_bytes = 0
        pending_pvals: Optional[tuple] = None
        try:
            for split in splits:
                table = futures.popleft().result()
                top_up()
                if table is None or table.num_rows == 0:
                    continue
                if (pending and
                        (pending_pvals != split.partition_values or
                         pending_rows + table.num_rows > max_rows or
                         pending_bytes + table.nbytes > max_bytes)):
                    yield self._upload(pending, pending_pvals, t0)
                    t0 = time.perf_counter_ns()
                    pending, pending_rows, pending_bytes = [], 0, 0
                pending.append(table)
                pending_pvals = split.partition_values
                pending_rows += table.num_rows
                pending_bytes += table.nbytes
            if pending:
                yield self._upload(pending, pending_pvals, t0)
        finally:
            for f in futures:  # a consumer that stopped early
                f.cancel()

    def _upload(self, tables: list, pvals, t0: int) -> ColumnarBatch:
        import pyarrow as pa

        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        from spark_rapids_tpu_torch.utils import metrics as M
        table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        buffer_ns = time.perf_counter_ns() - t0
        TpuSemaphore.get().acquire_if_necessary()
        t1 = time.perf_counter_ns()
        batch = ColumnarBatch.from_arrow(table, self.device)
        batch = _conform(batch, self.read_schema)
        batch = append_partition_values(batch, self.part_schema, pvals or ())
        if self.metrics is not None:
            self.metrics.add(M.BUFFER_TIME, buffer_ns)
            self.metrics.add(M.DECODE_TIME, time.perf_counter_ns() - t1)
            self.metrics.add(M.UPLOAD_BYTES, batch.device_size_bytes())
        return batch


def _conform(batch: ColumnarBatch, schema: T.Schema) -> ColumnarBatch:
    """Schema evolution: reorder to the read schema, add missing columns
    as nulls, cast widened types."""
    cols = []
    for f in schema.fields:
        try:
            idx = batch.schema.index(f.name)
        except KeyError:
            cols.append(ColumnVector.from_scalar(
                None, f.dtype, batch.capacity, batch.num_rows,
                device=batch.device))
            continue
        c = batch.columns[idx]
        if c.dtype != f.dtype:
            from spark_rapids_tpu_torch.exec.base import make_eval_context
            from spark_rapids_tpu_torch.exprs.base import BoundReference
            from spark_rapids_tpu_torch.exprs.cast import Cast
            ctx = make_eval_context([c], batch.capacity, batch.num_rows)
            c = Cast(BoundReference(0, c.dtype), f.dtype).eval(ctx)
        cols.append(c)
    return ColumnarBatch(schema, cols, batch.num_rows)
