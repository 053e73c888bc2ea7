"""File write path (port of spark_rapids_tpu/io/writer.py): the commit
protocol, the single-directory and dynamic-partition writers, and write
statistics.

The commit protocol is Hadoop's FileOutputCommitter v1 shape: tasks
write under `_temporary/<job>/_attempt_*`, task commit renames into the
job's staging directory, job commit moves everything to the final
location and writes `_SUCCESS`.

Dynamic partitioning is sort-based: each batch is ordered by its
partition columns on its own device, cut into runs of equal values, and
each run streams through one open writer at a time.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import uuid
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    bucket_capacity)


@dataclasses.dataclass
class WriteStats:
    """What a write produced (Spark's BasicWriteTaskStats)."""
    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    partitions: list = dataclasses.field(default_factory=list)

    def merge(self, other: "WriteStats") -> "WriteStats":
        return WriteStats(self.num_files + other.num_files,
                          self.num_rows + other.num_rows,
                          self.num_bytes + other.num_bytes,
                          self.partitions + other.partitions)


#: dropped (never moved to the output) at job commit
_COMMIT_MARKER = "_COMMITTED"


def _writer_factory(file_format: str, options):
    if file_format == "parquet":
        from spark_rapids_tpu_torch.io.parquet import (
            ParquetColumnarWriter, ParquetWriterOptions)
        return (ParquetColumnarWriter, options or ParquetWriterOptions(),
                ".parquet")
    if file_format == "orc":
        from spark_rapids_tpu_torch.io.orc import (OrcColumnarWriter,
                                                   OrcWriterOptions)
        return OrcColumnarWriter, options or OrcWriterOptions(), ".orc"
    raise ValueError(f"unsupported write format {file_format}")


class WriteJob:
    """Job-level commit protocol (Spark's FileFormatWriter.write and
    InsertIntoHadoopFsRelationCommand): FileOutputCommitter-v1 shape,
    with a task-attempt level:

      task attempt writes under  _temporary/<job>/_attempt_<task>_<uuid>/
      task commit                one atomic rename to
                                 _temporary/<job>/task_<task>/
      job commit                 move every committed task's files to the
                                 final dirs, then _SUCCESS

    The atomic task-commit rename makes duplicate/speculative attempts
    safe: exactly one attempt's rename can succeed for a task id; the
    loser deletes its own attempt dir and contributes no files or
    stats.  Task abort removes only that attempt's dir — committed
    output and other in-flight attempts are untouched.

    Modes: error | append | overwrite | dynamic_overwrite.
    dynamic_overwrite is Spark's INSERT OVERWRITE with
    spark.sql.sources.partitionOverwriteMode=dynamic: only partitions
    actually present in the new data are replaced at job commit;
    untouched partitions survive."""

    def __init__(self, output_path: str, file_format: str,
                 schema: T.Schema, partition_by: Sequence[str] = (),
                 mode: str = "error", options=None):
        self.output_path = output_path
        self.file_format = file_format
        self.schema = schema
        self.partition_by = list(partition_by)
        self.mode = mode
        self.options = options
        if mode == "dynamic_overwrite" and not self.partition_by:
            raise ValueError(
                "dynamic_overwrite requires partition_by columns")
        # validate the format BEFORE setup() can destroy existing output
        self._writer_cls, self._writer_opts, self._ext = _writer_factory(
            file_format, options)
        self.job_id = uuid.uuid4().hex[:12]
        self.staging = os.path.join(output_path, "_temporary", self.job_id)

    def setup(self) -> None:
        if os.path.exists(self.output_path) and self.mode == "error" and \
                any(not n.startswith("_") for n in os.listdir(
                    self.output_path)):
            raise FileExistsError(
                f"path {self.output_path} already exists (mode=error)")
        if self.mode == "overwrite" and os.path.exists(self.output_path):
            shutil.rmtree(self.output_path)
        os.makedirs(self.staging, exist_ok=True)

    def task_writer(self, task_id: int) -> "DataWriter":
        data_schema = T.Schema(tuple(
            f for f in self.schema.fields if f.name not in self.partition_by))
        cls = (DynamicPartitionDataWriter if self.partition_by
               else SingleDirectoryDataWriter)
        return cls(self, task_id, data_schema, self._writer_cls,
                   self._writer_opts, self._ext)

    def _committed_task_dirs(self) -> list:
        if not os.path.isdir(self.staging):
            return []
        return sorted(os.path.join(self.staging, n)
                      for n in os.listdir(self.staging)
                      if n.startswith("task_"))

    def commit(self, task_stats: Sequence[WriteStats]) -> WriteStats:
        """Move committed task output from staging to the final dir.
        Only `task_<id>` dirs (atomically renamed by task commit) are
        moved — files from uncommitted/aborted attempts never reach
        the output."""
        task_dirs = self._committed_task_dirs()
        if self.mode == "dynamic_overwrite":
            # replace exactly the partitions present in the new data
            touched = set()
            for td in task_dirs:
                for root, _dirs, names in os.walk(td):
                    rel = os.path.relpath(root, td)
                    if names and rel != ".":
                        touched.add(rel)
            for rel in sorted(touched):
                dest = os.path.join(self.output_path, rel)
                if os.path.isdir(dest):
                    shutil.rmtree(dest)
        for td in task_dirs:
            for root, _dirs, names in os.walk(td):
                rel = os.path.relpath(root, td)
                dest_dir = (self.output_path if rel == "."
                            else os.path.join(self.output_path, rel))
                os.makedirs(dest_dir, exist_ok=True)
                for n in names:
                    if n == _COMMIT_MARKER:
                        continue
                    os.replace(os.path.join(root, n),
                               os.path.join(dest_dir, n))
        shutil.rmtree(os.path.join(self.output_path, "_temporary"),
                      ignore_errors=True)
        with open(os.path.join(self.output_path, "_SUCCESS"), "w"):
            pass
        total = WriteStats()
        for s in task_stats:
            total = total.merge(s)
        return total

    def abort(self) -> None:
        shutil.rmtree(os.path.join(self.output_path, "_temporary"),
                      ignore_errors=True)


class DataWriter:
    """Task-ATTEMPT writer (Spark's FileFormatDataWriter).  All
    files land in this attempt's private dir; `commit()` publishes
    them with one atomic rename to the task's committed dir, and
    `abort()` removes the attempt dir without touching anything
    published.  Safe under duplicate/speculative attempts for the
    same task id: the rename can succeed for exactly one attempt."""

    def __init__(self, job: WriteJob, task_id: int, data_schema: T.Schema,
                 writer_cls, writer_opts, ext: str):
        self.job = job
        self.task_id = task_id
        self.data_schema = data_schema
        self.writer_cls = writer_cls
        self.writer_opts = writer_opts
        self.ext = ext
        self.stats = WriteStats()
        self._seq = 0
        self.attempt_id = uuid.uuid4().hex[:8]
        self.attempt_dir = os.path.join(
            job.staging, f"_attempt_{task_id:05d}_{self.attempt_id}")

    def _new_file(self, subdir: str = "") -> str:
        name = (f"part-{self.task_id:05d}-{self.job.job_id}"
                f"-{self._seq:03d}{self.ext}")
        self._seq += 1
        d = os.path.join(self.attempt_dir, subdir)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def write(self, batch: ColumnarBatch) -> None:
        raise NotImplementedError

    def _close_writers(self) -> None:
        pass

    def commit(self) -> WriteStats:
        """Close files, then publish the attempt with ONE atomic
        rename.  A lost speculative race (committed dir already
        exists) discards this attempt's files and stats — the winner's
        output is what the job sees; duplicates can't double-count."""
        self._close_writers()
        committed = os.path.join(self.job.staging,
                                 f"task_{self.task_id:05d}")
        os.makedirs(self.attempt_dir, exist_ok=True)
        # marker guarantees the committed dir is never EMPTY: POSIX
        # rename silently REPLACES an empty destination directory,
        # which would let a late speculative attempt overwrite an
        # already-committed zero-output task; with the marker present
        # the loser's rename always fails ENOTEMPTY
        with open(os.path.join(self.attempt_dir, _COMMIT_MARKER), "w"):
            pass
        try:
            os.rename(self.attempt_dir, committed)
        except OSError:
            # another attempt already committed this task id
            shutil.rmtree(self.attempt_dir, ignore_errors=True)
            return WriteStats()
        return self.stats

    def abort(self) -> None:
        self._close_writers()
        shutil.rmtree(self.attempt_dir, ignore_errors=True)


class SingleDirectoryDataWriter(DataWriter):
    def __init__(self, *a):
        super().__init__(*a)
        self._writer = None

    def write(self, batch: ColumnarBatch) -> None:
        batch = batch.dense()
        if batch.num_rows == 0:
            return
        if self._writer is None:
            self._writer = self.writer_cls(
                self._new_file(), self.data_schema, self.writer_opts)
        self._writer.write_batch(batch.select(self.data_schema.names))

    def _close_writers(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self.stats.num_files += 1
            self.stats.num_rows += self._writer.rows_written
            self.stats.num_bytes += self._writer.bytes_written
            self._writer = None


def _escape_path_value(v) -> str:
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    s = str(v)
    out = []
    for ch in s:
        out.append(f"%{ord(ch):02X}" if ch in '/\\:*?"<>|%' else ch)
    return "".join(out)


def _run_codes(c: ColumnVector, n: int) -> tuple[torch.Tensor, int]:
    """int64 codes of the first n rows of `c` that sort as the values do
    (strings by their bytes, then their length), nulls last, and the
    number of codes."""
    vals = c.data[:n]
    if c.dtype.is_string:
        inside = torch.arange(c.char_cap, device=c.device)[None, :] < \
            c.lengths[:n, None]
        by_bytes = torch.unique(torch.where(inside, vals, 0), dim=0,
                                return_inverse=True)[1]
        vals = by_bytes * (c.char_cap + 1) + c.lengths[:n]
    uniq, codes = torch.unique(vals, return_inverse=True)
    k = uniq.shape[0]
    return torch.where(c.validity[:n], codes, k), k + 1


def _partition_runs(columns: list, n: int) -> tuple[torch.Tensor, list]:
    """The row order that groups the first n rows by the columns' values
    (lexicographic over the columns, nulls last) and the length of each
    run of equal values, in that order."""
    combined = torch.zeros(n, dtype=torch.int64, device=columns[0].device)
    for c in columns:
        codes, k = _run_codes(c, n)
        combined = combined * k + codes
    keys, order = torch.sort(combined, stable=True)
    counts = torch.unique_consecutive(keys, return_counts=True)[1]
    return order, counts.cpu().tolist()


class DynamicPartitionDataWriter(DataWriter):
    """Sort-based dynamic partitioning with one open writer: each batch
    is ordered by its partition columns and cut into runs of equal
    values; a new run rolls to the next file."""

    def __init__(self, *a):
        super().__init__(*a)
        self._writer = None
        self._current_key: Optional[tuple] = None

    def write(self, batch: ColumnarBatch) -> None:
        batch = batch.dense()
        if batch.num_rows == 0:
            return
        n = batch.num_rows
        order, counts = _partition_runs(
            [batch.column(name) for name in self.job.partition_by], n)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        dev = batch.device
        # the key of every run, from one download of its first rows
        firsts = order[torch.as_tensor(starts, device=dev)]
        heads = [batch.column(name).gather(firsts).to_numpy(len(starts))
                 for name in self.job.partition_by]
        for r, (s, cnt) in enumerate(zip(starts, counts)):
            key = tuple(None if not valid[r] else
                        vals[r].item() if hasattr(vals[r], "item")
                        else vals[r] for vals, valid in heads)
            if key != self._current_key:
                self._roll(key)
            cap = bucket_capacity(int(cnt))
            i = torch.arange(cap, device=dev)
            valid = i < int(cnt)
            idx = order[torch.where(valid, i + int(s), 0)]
            sub = batch.gather(idx, valid, int(cnt))
            self._writer.write_batch(sub.select(self.data_schema.names))

    def _roll(self, key: tuple) -> None:
        self._close_current()
        subdir = os.path.join(*[
            f"{name}={_escape_path_value(v)}"
            for name, v in zip(self.job.partition_by, key)])
        self._writer = self.writer_cls(
            self._new_file(subdir), self.data_schema, self.writer_opts)
        self._current_key = key
        self.stats.partitions.append(subdir)

    def _close_current(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self.stats.num_files += 1
            self.stats.num_rows += self._writer.rows_written
            self.stats.num_bytes += self._writer.bytes_written
            self._writer = None

    def _close_writers(self) -> None:
        self._close_current()


def write_batches(batches: Iterator[ColumnarBatch], output_path: str,
                  file_format: str, schema: T.Schema,
                  partition_by: Sequence[str] = (), mode: str = "error",
                  options=None) -> WriteStats:
    """Single-task convenience driver for the full job protocol."""
    job = WriteJob(output_path, file_format, schema, partition_by, mode,
                   options)
    job.setup()
    writer = job.task_writer(0)
    try:
        for b in batches:
            writer.write(b)
        stats = writer.commit()
    except BaseException:
        writer.abort()
        job.abort()
        raise
    return job.commit([stats])
