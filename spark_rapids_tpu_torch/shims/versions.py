"""Per-version shims (port of spark_rapids_tpu/shims/versions.py;
reference `shims/spark300`, `spark300db`, `spark301`, `spark302`,
`spark310`).  Each class carries only what drifted from its parent."""
from __future__ import annotations

from spark_rapids_tpu_torch.shims.base import SparkShims


class Spark300Shims(SparkShims):
    """Spark 3.0.0: the base behavior set."""
    VERSION_NAMES = ("3.0.0",)


class Spark300dbShims(Spark300Shims):
    """Databricks 3.0.0: its forked AQE classes, its own shuffle manager
    package, and a getPartitionSplitFiles that packs whole files."""
    VERSION_NAMES = ("3.0.0-databricks",)

    def aqe_shuffle_reader_name(self) -> str:
        # the Databricks runtime forked AQE before upstream named it
        return "DatabricksShuffleReaderExec"

    def make_query_stage_prep_rule(self, conf, factory):
        rule = factory(conf)

        def db_rule(plan):
            return rule(plan)
        db_rule.__name__ = "DatabricksQueryStagePrepRule"
        return db_rule

    def shuffle_manager_class(self) -> str:
        return "spark_rapids_tpu_torch.shims.spark300db.RapidsShuffleManager"

    def plan_file_partitions(self, files, max_bytes, open_cost,
                             min_partitions: int = 1):
        from spark_rapids_tpu_torch.io.scan import plan_file_partitions
        return plan_file_partitions(files, max_bytes, open_cost,
                                    min_partitions=min_partitions,
                                    split_files=False)


class Spark301Shims(Spark300Shims):
    """Spark 3.0.1: the renamed rebase confs, defaulting to EXCEPTION,
    and its own shuffle manager package."""
    VERSION_NAMES = ("3.0.1",)

    def shuffle_manager_class(self) -> str:
        return "spark_rapids_tpu_torch.shims.spark301.RapidsShuffleManager"

    def parquet_rebase_read_key(self) -> str:
        return "spark.sql.legacy.parquet.datetimeRebaseModeInRead"

    def parquet_rebase_write_key(self) -> str:
        return "spark.sql.legacy.parquet.datetimeRebaseModeInWrite"

    def parquet_rebase_default(self) -> str:
        return "EXCEPTION"


class Spark302Shims(Spark301Shims):
    """Spark 3.0.2: 3.0.1's surface but for the shuffle manager
    package."""
    VERSION_NAMES = ("3.0.2",)

    def shuffle_manager_class(self) -> str:
        return "spark_rapids_tpu_torch.shims.spark302.RapidsShuffleManager"


class Spark310Shims(Spark301Shims):
    """Spark 3.1.0: the accelerated device-exit transition, map-index
    range reads (AQE skew splits), and a user's repartition keeps its
    partition count."""
    VERSION_NAMES = ("3.1.0", "3.1.1-SNAPSHOT")

    def columnar_to_row_transition(self, tpu_child):
        from spark_rapids_tpu_torch.plan.transitions import \
            AcceleratedColumnarToRowExec
        return AcceleratedColumnarToRowExec(tpu_child)

    def supports_map_index_ranges(self) -> bool:
        return True

    def shuffle_manager_class(self) -> str:
        return "spark_rapids_tpu_torch.shims.spark310.RapidsShuffleManager"

    def make_shuffle_exchange(self, partitioning, child,
                              can_change_num_partitions: bool = True):
        # 3.1's ShuffleExchangeLike: AQE honors canChangeNumPartitions
        ex = super().make_shuffle_exchange(partitioning, child)
        ex.can_change_num_partitions = can_change_num_partitions
        return ex


ALL_SHIMS = (Spark300Shims, Spark300dbShims, Spark301Shims, Spark302Shims,
             Spark310Shims)
