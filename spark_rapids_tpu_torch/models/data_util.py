"""Workload-data plumbing (port of spark_rapids_tpu/models/data_util.py):
DataFrame partition splitting and CpuSource construction."""
from __future__ import annotations

import numpy as np
import pandas as pd


def split_partitions(df: pd.DataFrame, num_partitions: int
                     ) -> list[pd.DataFrame]:
    if num_partitions <= 1 or len(df) < num_partitions:
        return [df]
    bounds = np.linspace(0, len(df), num_partitions + 1).astype(int)
    return [df.iloc[bounds[i]:bounds[i + 1]].reset_index(drop=True)
            for i in range(num_partitions)]


def make_sources(tables: dict, schemas: dict, num_partitions: int = 1):
    """Wrap generated tables as CpuSource plan leaves with declared
    schemas."""
    from spark_rapids_tpu_torch.plan.nodes import CpuSource
    return {name: CpuSource(split_partitions(df, num_partitions),
                            schemas[name])
            for name, df in tables.items()}
