"""The shim surface (port of spark_rapids_tpu/shims/base.py, cut to the
methods the I/O layer, the exchange and the brute-force joins call): the
hybrid-calendar rebase keys and modes, the shuffle exchange and
nested-loop join constructors, file partition planning and the
small-file scan copy.  The transitions, First/Last construction and AQE
come with the layers that call them."""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence


@dataclasses.dataclass(frozen=True, order=True)
class ShimVersion:
    """A parsed Spark version."""
    major: int
    minor: int
    patch: int
    databricks: bool = False

    def __str__(self):
        base = f"{self.major}.{self.minor}.{self.patch}"
        return base + ("-databricks" if self.databricks else "")

    @staticmethod
    def parse(s: str) -> "ShimVersion":
        db = "databricks" in s or "-db" in s
        m = re.match(r"^(\d+)\.(\d+)\.(\d+)", s)
        if not m:
            raise ValueError(f"cannot parse Spark version {s!r}")
        return ShimVersion(int(m.group(1)), int(m.group(2)),
                           int(m.group(3)), db)


class SparkShims:
    """Base shim: the Spark 3.0.0 behavior set.  Later versions subclass
    and override only what drifted."""

    #: exact version strings this shim serves
    VERSION_NAMES: tuple = ()

    @property
    def version(self) -> ShimVersion:
        return ShimVersion.parse(self.VERSION_NAMES[0])

    # -- config drift -------------------------------------------------------
    def parquet_rebase_read_key(self) -> str:
        """Hybrid-calendar rebase conf key; Spark 3.0.0 shipped the
        boolean-era name, renamed to the mode conf in 3.0.1."""
        return "spark.sql.legacy.parquet.rebaseDateTimeInRead"

    def parquet_rebase_write_key(self) -> str:
        return "spark.sql.legacy.parquet.rebaseDateTimeInWrite"

    def parquet_rebase_default(self) -> str:
        """Mode when the key is unset: 3.0.0's boolean keys default to
        false (read and write verbatim = CORRECTED); 3.0.1+ mode keys
        default to EXCEPTION."""
        return "CORRECTED"

    def parquet_rebase_read_mode(self, conf) -> str:
        from spark_rapids_tpu_torch.io import rebase as RB
        return RB.normalize_mode(conf.get(
            self.parquet_rebase_read_key(), self.parquet_rebase_default()))

    def parquet_rebase_write_mode(self, conf) -> str:
        from spark_rapids_tpu_torch.io import rebase as RB
        return RB.normalize_mode(conf.get(
            self.parquet_rebase_write_key(),
            self.parquet_rebase_default()))

    # -- exchange construction drift ----------------------------------------
    def make_shuffle_exchange(self, partitioning, child,
                              can_change_num_partitions: bool = True):
        """Shuffle exchange constructor: Spark 3.0 has no
        canChangeNumPartitions (AQE may always coalesce); 3.1's
        ShuffleExchangeLike carries the flag (Spark310Shims)."""
        from spark_rapids_tpu_torch.shuffle.exchange import \
            ShuffleExchangeExec
        ex = ShuffleExchangeExec(partitioning, child)
        ex.can_change_num_partitions = True  # 3.0 semantics
        return ex

    # -- join construction drift --------------------------------------------
    def make_nested_loop_join(self, join_type, left, right, condition,
                              target_size_bytes: int = 0):
        """Nested-loop join constructor (reference
        `getGpuBroadcastNestedLoopJoinShim`: the exec's constructor
        signature drifts per version; targetSizeBytes threading changed)."""
        from spark_rapids_tpu_torch.exec.joins import NestedLoopJoinExec
        j = NestedLoopJoinExec(left, right, condition, join_type)
        j.target_size_bytes = target_size_bytes
        return j

    # -- file scan ----------------------------------------------------------
    def make_file_partitions(self, files: Sequence, max_bytes: int,
                             open_cost: int = 4 * 1024 * 1024):
        """Pack (path, size) files into partitions, greedily by size plus
        open cost (Spark 3.0.x)."""
        parts, cur, cur_bytes = [], [], 0
        for f in sorted(files, key=lambda f: -f[1]):
            est = f[1] + open_cost
            if cur and cur_bytes + est > max_bytes:
                parts.append(cur)
                cur, cur_bytes = [], 0
            cur.append(f)
            cur_bytes += est
        if cur:
            parts.append(cur)
        return parts

    def plan_file_partitions(self, files, max_bytes: int, open_cost: int,
                             min_partitions: int = 1):
        """FilePartition planning (Databricks packs whole files only)."""
        from spark_rapids_tpu_torch.io.scan import plan_file_partitions
        return plan_file_partitions(files, max_bytes, open_cost,
                                    min_partitions=min_partitions)

    def copy_scan_with_small_file_opt(self, scan_exec, enabled: bool):
        """A copy of a file scan exec with the multi-file (small-file
        coalescing) reader toggled."""
        import copy as _copy

        from spark_rapids_tpu_torch.io.exec import TpuFileSourceScanExec
        sd = _copy.copy(scan_exec.scan)
        sd.small_file_opt = enabled
        return TpuFileSourceScanExec(sd, scan_exec.pushed_filter,
                                     scan_exec.conf, scan_exec.device())
