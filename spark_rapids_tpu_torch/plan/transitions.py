"""Plan transitions (port of spark_rapids_tpu/plan/transitions.py):
row <-> columnar bridges, the host-columnar upload, coalesce insertion,
redundant-transition elimination and the test-mode all-on-the-GPU
assertion.

The CPU side trades in pandas DataFrames with nullable dtypes; the
device side in ColumnarBatch.  `RowToColumnarExec` uploads,
`ColumnarToRowExec` downloads, and `HostColumnarToDeviceExec` uploads
cached Arrow tables column by column.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector, _upload,
                                                    bucket_capacity,
                                                    resolve_device,
                                                    strings_to_bytes)
from spark_rapids_tpu_torch.exec.base import (CoalesceGoal, TargetSize,
                                              TpuExec, max_goal)
from spark_rapids_tpu_torch.exec.coalesce import CoalesceBatchesExec
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.plan.cpu_eval import nullable_dtype
from spark_rapids_tpu_torch.plan.nodes import (CpuCachedColumnar, CpuNode,
                                               CpuSource, normalize_df)
from spark_rapids_tpu_torch.utils import metrics as M


def _string_vector(s: pd.Series, mask: np.ndarray, cap: int,
                   dev) -> ColumnVector:
    """A string Series on `dev`.  A categorical column encodes each
    category once, uploads the codes and gathers the bytes on the
    device."""
    if isinstance(s.dtype, pd.CategoricalDtype):
        cats = np.asarray(s.cat.categories, dtype=object)
        chars, lens = strings_to_bytes(cats, np.ones(len(cats), bool))
        codes = s.cat.codes.to_numpy()
        valid = _upload(codes >= 0, cap, dev)
        idx = _upload(codes, cap, dev).to(torch.int64).clamp(min=0)
        return ColumnVector(
            T.STRING, _upload(chars, len(chars), dev)[idx], valid,
            lengths=torch.where(valid, _upload(lens, len(lens), dev)[idx],
                                0))
    chars, lens = strings_to_bytes(s.to_numpy(dtype=object), ~mask)
    return ColumnVector(T.STRING, _upload(chars, cap, dev),
                        _upload(~mask, cap, dev),
                        lengths=_upload(lens, cap, dev))


def batch_from_df(df: pd.DataFrame, schema: T.Schema,
                  device="cuda") -> ColumnarBatch:
    """Host rows -> device batch in the schema's storage model, one
    upload per column."""
    dev = resolve_device(device)
    n = len(df)
    cap = bucket_capacity(n)
    cols = []
    for f in schema.fields:
        s = df[f.name]
        if f.dtype.id == T.TypeId.DATE32 and s.dtype == object:
            s = normalize_df(df[[f.name]], T.Schema((f,)))[f.name]
        mask = s.isna().to_numpy()
        if f.dtype.is_string:
            cols.append(_string_vector(s, mask, cap, dev))
            continue
        storage = f.dtype.storage_dtype
        if str(s.dtype).startswith(("Int", "Float", "boolean")):
            vals = s.fillna(False if str(s.dtype) == "boolean" else 0
                            ).to_numpy(dtype=storage)
        elif s.dtype.kind == "M":  # datetime64 -> int64 micros
            vals = s.to_numpy().astype("datetime64[us]").astype(np.int64)
            vals = np.where(mask, 0, vals)
        else:
            vals = s.to_numpy().astype(storage, copy=False)
            if mask.any() and vals.dtype.kind == "f":
                vals = np.where(mask, 0, vals)
        cols.append(ColumnVector.from_numpy(vals, f.dtype, ~mask, cap,
                                            device=dev))
    # movement ledger: the host->device construction point of rows (the
    # reference's from_pandas -> from_numpy, whose site name it keeps)
    from spark_rapids_tpu_torch.utils import movement as MV
    if cols and MV.ledger() is not None:
        MV.record(MV.EDGE_UPLOAD,
                  sum(MV.vector_device_bytes(c) for c in cols),
                  site="batch.from_numpy", rows=n)
    return ColumnarBatch(schema, cols, n)


def series_from_column(field: T.Field, vals, valid) -> pd.Series:
    """One host column -> nullable pandas Series."""
    if field.dtype.is_string:
        return pd.Series(list(vals), dtype=object)
    s = pd.Series(vals).astype(nullable_dtype(field.dtype))
    s[~np.asarray(valid)] = pd.NA
    return s


def df_from_batch(batch: ColumnarBatch) -> pd.DataFrame:
    """Device batch -> host rows with nullable dtypes (DATE32 stays int
    days, TIMESTAMP_US int micros), after the batch's deferred checks
    verify."""
    batch = batch.dense()
    # movement ledger: the engine's result sink pulls the batch (the
    # collect-boundary readback)
    from spark_rapids_tpu_torch.utils import movement as MV
    if MV.ledger() is not None:
        MV.record(MV.EDGE_READBACK, batch.device_size_bytes(),
                  site="collect.df_from_batch")
    batch.verify_checks()
    out = {}
    for f, c in zip(batch.schema.fields, batch.columns):
        vals, valid = c.to_numpy(batch.num_rows)
        out[f.name] = series_from_column(f, vals, valid)
    return pd.DataFrame(out)


class RowToColumnarExec(TpuExec):
    """Runs a CPU subtree and uploads its partitions to `device`, in
    chunks of at most spark.rapids.tpu.batchMaxRows rows (a leaf from
    the device tree's viewpoint)."""

    def __init__(self, cpu_child: CpuNode, device):
        super().__init__()
        self.cpu_child = cpu_child
        self._device = resolve_device(device)
        self._schema = cpu_child.output_schema()

    def output_schema(self) -> T.Schema:
        return self._schema

    def device(self) -> torch.device:
        return self._device

    def output_partition_count(self) -> int:
        return self.cpu_child.output_partition_count()

    def describe(self):
        return f"RowToColumnarExec\n{self.cpu_child.tree_string(1)}"

    def execute_partitions(self):
        max_rows = C.get_active_conf()[C.MAX_BATCH_ROWS]

        def convert(it):
            for df in it:
                for lo in range(0, len(df), max_rows):
                    # the device admission boundary: a task takes its
                    # permit before its first upload (no-op outside one)
                    TpuSemaphore.get().acquire_if_necessary()
                    b = batch_from_df(df.iloc[lo:lo + max_rows],
                                      self._schema, self._device)
                    self.update_output_metrics(b)
                    yield b
        return [convert(it) for it in self.cpu_child.execute()]


class HostColumnarToDeviceExec(TpuExec):
    """Cached host-columnar partitions (Arrow tables) -> device batches
    through ColumnarBatch.from_arrow, with no pivot through rows; tables
    larger than spark.rapids.tpu.batchMaxRows upload in slices."""

    def __init__(self, cpu_source: CpuCachedColumnar, device):
        super().__init__()
        self.cpu_source = cpu_source
        self._device = resolve_device(device)
        self._schema = cpu_source.output_schema()

    def output_schema(self) -> T.Schema:
        return self._schema

    def device(self) -> torch.device:
        return self._device

    def output_partition_count(self) -> int:
        return self.cpu_source.output_partition_count()

    def describe(self):
        return (f"HostColumnarToDeviceExec("
                f"{len(self.cpu_source.partitions)} cached partitions)")

    def execute_partitions(self):
        max_rows = C.get_active_conf()[C.MAX_BATCH_ROWS]

        def convert(table):
            for off in range(0, table.num_rows, max_rows):
                # the device admission boundary, as in RowToColumnarExec
                TpuSemaphore.get().acquire_if_necessary()
                with self.metrics.timed(M.TOTAL_TIME):
                    b = ColumnarBatch.from_arrow(
                        table.slice(off, max_rows), self._device,
                        self._schema)
                self.update_output_metrics(b)
                yield b
        return [convert(t) for t in self.cpu_source.partitions] or \
            [iter(())]


class ColumnarToRowExec(CpuNode):
    """Runs a device subtree and downloads its batches to pandas rows."""

    def __init__(self, tpu_child: TpuExec):
        super().__init__()
        self.tpu_child = tpu_child
        self._schema = tpu_child.output_schema()

    def output_schema(self) -> T.Schema:
        return self._schema

    def output_partition_count(self) -> int:
        return self.tpu_child.output_partition_count()

    def describe(self):
        return f"{self.name()}\n{self.tpu_child.tree_string(1)}"

    def execute(self):
        def convert(it):
            from spark_rapids_tpu_torch.utils import checks as CK
            for batch in it:
                # the device exit blocks on the batch's readback; its
                # bytes go to the ledger in df_from_batch
                CK.note_host_sync("transition.device_get")
                df = df_from_batch(batch)
                # the device exit boundary releases the task's permit
                TpuSemaphore.get().release_if_necessary()
                yield df
        return [convert(it) for it in self.tpu_child.execute_partitions()]


class AcceleratedColumnarToRowExec(ColumnarToRowExec):
    """Spark 3.1.0's accelerated device-exit transition (reference
    `getGpuColumnarToRowTransition`, spark310 shim): the fixed-width
    columns of a batch and their validity leave the device in one packed
    copy instead of one copy each."""

    def execute(self):
        def convert(it):
            from spark_rapids_tpu_torch.utils import checks as CK
            for batch in it:
                CK.note_host_sync("transition.device_get")
                df = _df_from_batch_packed(batch)
                TpuSemaphore.get().release_if_necessary()
                yield df
        return [convert(it) for it in self.tpu_child.execute_partitions()]


def _df_from_batch_packed(batch: ColumnarBatch) -> pd.DataFrame:
    """df_from_batch with one device-to-host copy for every fixed-width
    tensor of the batch (each padded to 8 bytes, so each slice of the
    host buffer views back as its own dtype)."""
    batch = batch.dense()
    from spark_rapids_tpu_torch.utils import movement as MV
    if MV.ledger() is not None:
        MV.record(MV.EDGE_READBACK, batch.device_size_bytes(),
                  site="collect.df_from_batch")
    batch.verify_checks()
    n = batch.num_rows
    parts, layout = [], []
    for c in batch.columns:
        if c.dtype.is_string:
            continue
        for t in (c.data[:n], c.validity[:n]):
            b = t.contiguous().view(torch.uint8)
            pad = (-b.numel()) % 8
            parts += [b, b.new_zeros(pad)] if pad else [b]
            layout.append((t.dtype, b.numel(), pad))
    host = torch.cat(parts).cpu() if parts else None
    out, off, k = {}, 0, 0
    for f, c in zip(batch.schema.fields, batch.columns):
        if f.dtype.is_string:
            vals, valid = c.to_numpy(n)
        else:
            pair = []
            for dtype, nbytes, pad in layout[k:k + 2]:
                pair.append(host[off:off + nbytes].view(dtype).numpy())
                off += nbytes + pad
            k += 2
            vals, valid = pair
        out[f.name] = series_from_column(f, vals, valid)
    return pd.DataFrame(out)


# ---------------------------------------------------------------------------
def insert_coalesce(plan: TpuExec, conf: C.RapidsConf) -> TpuExec:
    """Insert CoalesceBatchesExec per each node's children_coalesce_goal
    and above batch-shrinking nodes."""
    _insert_coalesce_walk(plan, TargetSize(conf[C.BATCH_SIZE_BYTES]),
                          conf[C.MAX_BATCH_ROWS])
    return plan


def _insert_coalesce_walk(node: TpuExec, target: TargetSize,
                          max_rows: Optional[int] = None) -> None:
    if isinstance(node, RowToColumnarExec):
        # device subtrees inside the CPU island need coalesce too
        _coalesce_cpu_islands(node.cpu_child, target, max_rows)
        return
    goals = node.children_coalesce_goal()
    for i, child in enumerate(list(node.children)):
        goal: Optional[CoalesceGoal] = goals[i] if i < len(goals) else None
        if child.coalesce_after:
            goal = max_goal(goal, target)
        if goal is not None and not isinstance(child, CoalesceBatchesExec):
            node._children[i] = CoalesceBatchesExec(goal, child, max_rows)
        _insert_coalesce_walk(child, target, max_rows)


def _coalesce_cpu_islands(node: CpuNode, target: TargetSize,
                          max_rows: Optional[int] = None) -> None:
    if isinstance(node, ColumnarToRowExec):
        _insert_coalesce_walk(node.tpu_child, target, max_rows)
        return
    for c in node.children:
        _coalesce_cpu_islands(c, target, max_rows)


def optimize_transitions(node: CpuNode) -> CpuNode:
    """Remove C2R(R2C(x)) / R2C(C2R(x)) pairs introduced at CPU
    islands."""
    if isinstance(node, ColumnarToRowExec):
        node.tpu_child = _optimize_tpu(node.tpu_child)
        if isinstance(node.tpu_child, RowToColumnarExec):
            return optimize_transitions(node.tpu_child.cpu_child)
        return node
    node.children = [optimize_transitions(c) for c in node.children]
    return node


def _optimize_tpu(node: TpuExec) -> TpuExec:
    if isinstance(node, RowToColumnarExec):
        node.cpu_child = optimize_transitions(node.cpu_child)
        if isinstance(node.cpu_child, ColumnarToRowExec):
            return _optimize_tpu(node.cpu_child.tpu_child)
        return node
    node._children = [_optimize_tpu(c) for c in node.children]
    return node


def assert_is_on_tpu(plan, allowed: frozenset = frozenset()) -> None:
    """Test hook (spark.rapids.sql.test.enabled): every CPU node but the
    sources must be in `allowed`, else this raises."""
    def walk_cpu(node: CpuNode):
        if isinstance(node, ColumnarToRowExec):
            walk_tpu(node.tpu_child)
            return
        if not isinstance(node, CpuSource) and node.name() not in allowed:
            raise AssertionError(
                f"plan node {node.name()} did not run on the GPU:\n"
                f"{node.tree_string()}")
        for c in node.children:
            walk_cpu(c)

    def walk_tpu(node: TpuExec):
        if isinstance(node, RowToColumnarExec):
            walk_cpu(node.cpu_child)
            return
        for c in node.children:
            walk_tpu(c)

    if isinstance(plan, TpuExec):
        walk_tpu(plan)
    else:
        walk_cpu(plan)
