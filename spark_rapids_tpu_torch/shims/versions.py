"""Per-version shims (port of spark_rapids_tpu/shims/versions.py, with
the overrides of the methods base.py ports).  Each class carries only
what drifted from its parent."""
from __future__ import annotations

from spark_rapids_tpu_torch.shims.base import SparkShims


class Spark300Shims(SparkShims):
    """Spark 3.0.0: the base behavior set."""
    VERSION_NAMES = ("3.0.0",)


class Spark300dbShims(Spark300Shims):
    """Databricks 3.0.0: its getPartitionSplitFiles packs whole files."""
    VERSION_NAMES = ("3.0.0-databricks",)

    def plan_file_partitions(self, files, max_bytes, open_cost,
                             min_partitions: int = 1):
        from spark_rapids_tpu_torch.io.scan import plan_file_partitions
        return plan_file_partitions(files, max_bytes, open_cost,
                                    min_partitions=min_partitions,
                                    split_files=False)


class Spark301Shims(Spark300Shims):
    """Spark 3.0.1: the renamed rebase confs, defaulting to EXCEPTION."""
    VERSION_NAMES = ("3.0.1",)

    def parquet_rebase_read_key(self) -> str:
        return "spark.sql.legacy.parquet.datetimeRebaseModeInRead"

    def parquet_rebase_write_key(self) -> str:
        return "spark.sql.legacy.parquet.datetimeRebaseModeInWrite"

    def parquet_rebase_default(self) -> str:
        return "EXCEPTION"


class Spark302Shims(Spark301Shims):
    """Spark 3.0.2: 3.0.1's surface."""
    VERSION_NAMES = ("3.0.2",)


class Spark310Shims(Spark301Shims):
    """Spark 3.1.0: a user's repartition keeps its partition count."""
    VERSION_NAMES = ("3.1.0", "3.1.1-SNAPSHOT")

    def make_shuffle_exchange(self, partitioning, child,
                              can_change_num_partitions: bool = True):
        # 3.1's ShuffleExchangeLike: AQE honors canChangeNumPartitions
        ex = super().make_shuffle_exchange(partitioning, child)
        ex.can_change_num_partitions = can_change_num_partitions
        return ex


ALL_SHIMS = (Spark300Shims, Spark300dbShims, Spark301Shims, Spark302Shims,
             Spark310Shims)
