"""ML integration: columnar export (port of
spark_rapids_tpu/ml/columnar_rdd.py; reference `ColumnarRdd.scala:41-46`,
`InternalColumnarRddConverter.scala:470` and
`GpuTransitionOverrides.detectAndTagFinalColumnarOutput`).

The reference hands a query's final columnar output to XGBoost as an
`RDD[ai.rapids.cudf.Table]`, so training reads device-resident data
without a row round trip.  Here the final `ColumnarBatch` stream, torch
tensors already on the card, goes to PyTorch ML code as it is:
`collect_arrays` gives one tensor per column that stays on the card.

Gated by spark.rapids.sql.exportColumnarRdd, as in the reference.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.plan.nodes import CpuNode


class ColumnarRdd:
    """Driver-facing API (reference `ColumnarRdd.convert(df)`)."""

    @staticmethod
    def convert(plan, conf: Optional[C.RapidsConf] = None, device="cuda"
                ) -> list[Iterator[ColumnarBatch]]:
        """Accelerate `plan` for `device` and return its partitions as
        iterators of device batches.  A plan wholly on the device exports
        its batches as they are; a plan with CPU islands is converted
        partition by partition as it runs (the reference's
        InternalColumnarRddConverter row path).  device="cuda" without a
        card raises."""
        conf = conf or C.get_active_conf()
        if not conf[C.EXPORT_COLUMNAR_RDD]:
            raise RuntimeError(
                "columnar export requires "
                f"{C.EXPORT_COLUMNAR_RDD.key}=true (reference "
                "ColumnarRdd.scala:41-46)")
        from spark_rapids_tpu_torch.plan.overrides import accelerate
        out = plan if isinstance(plan, TpuExec) \
            else accelerate(plan, conf, device)
        if isinstance(out, TpuExec):
            with C.session(conf):
                return out.execute_partitions()
        return _rows_to_batches(out, getattr(out, "_session_device", device))

    @staticmethod
    def collect_arrays(plan, conf: Optional[C.RapidsConf] = None,
                       device="cuda") -> dict[str, torch.Tensor]:
        """Every partition concatenated into one dict of column ->
        tensor on the device, cut to the true row count: the hand-off a
        PyTorch training loop wants (the XGBoost DMatrix of the
        reference).  String columns are dropped; a float null is NaN,
        and an integer column with nulls raises."""
        conf = conf or C.get_active_conf()
        parts = ColumnarRdd.convert(plan, conf, device)
        with C.session(conf):
            batches = [b for it in parts for b in it]
        if not batches:
            return {}
        from spark_rapids_tpu_torch.columnar.batch import concat_batches
        merged = concat_batches(batches).dense()
        n = merged.num_rows
        out = {}
        for f, c in zip(merged.schema.fields, merged.columns):
            if f.dtype.is_string:
                continue  # string features are not trainable tensors
            data, valid = c.data[:n], c.validity[:n]
            if f.dtype.is_floating:
                # a null is NaN, never a made-up fill value
                data = torch.where(valid, data,
                                   torch.full_like(data, float("nan")))
            elif not bool(valid.all()):
                raise ValueError(
                    f"column {f.name} ({f.dtype}) holds nulls, which an "
                    "integer or date tensor cannot represent: filter or "
                    "coalesce them in the query first")
            out[f.name] = data
        return out


def _rows_to_batches(cpu_plan: CpuNode, device
                     ) -> list[Iterator[ColumnarBatch]]:
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    schema = cpu_plan.output_schema()

    def gen(it):
        for df in it:
            if len(df):
                yield batch_from_df(df, schema, device)
    return [gen(it) for it in cpu_plan.execute()]
