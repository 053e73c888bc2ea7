"""The shim surface (port of spark_rapids_tpu/shims/base.py; reference
`SparkShims.scala:57-136`): everything that varies across the supported
Spark versions routes through a `SparkShims` instance resolved from the
session's Spark version: the device-exit transition, First/Last
construction, the per-version shuffle manager class, AQE's map-output
range reads and reader name, build sides, the exchange and join
constructors, the query-stage prep rule, file partition planning, the
hybrid-calendar rebase keys and modes, and per-version extra rules."""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence


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

    # -- transitions --------------------------------------------------------
    def columnar_to_row_transition(self, tpu_child):
        """The device-exit transition exec; 3.1.0 takes an accelerated
        one (reference `getGpuColumnarToRowTransition`, spark310)."""
        from spark_rapids_tpu_torch.plan.transitions import ColumnarToRowExec
        return ColumnarToRowExec(tpu_child)

    # -- expression construction drift --------------------------------------
    def make_first_last(self, child, last: bool, ignore_nulls: bool):
        """First/Last aggregate constructor (its ignoreNulls argument
        became a plain boolean in 3.0.1; the reference's shims carry
        per-version GpuFirst/GpuLast)."""
        from spark_rapids_tpu_torch.exprs.aggregates import First, Last
        return (Last if last else First)(child,
                                         ignore_nulls=bool(ignore_nulls))

    # -- shuffle / AQE ------------------------------------------------------
    def shuffle_manager_class(self) -> str:
        """The per-version shuffle manager users name in
        spark.shuffle.manager (reference
        `shims/spark300/.../RapidsShuffleManager.scala`)."""
        return "spark_rapids_tpu_torch.shims.spark300.RapidsShuffleManager"

    def shuffle_manager_type(self) -> type:
        """The class `shuffle_manager_class()` names, imported."""
        import importlib
        mod, name = self.shuffle_manager_class().rsplit(".", 1)
        return getattr(importlib.import_module(mod), name)

    def supports_map_index_ranges(self) -> bool:
        """Spark 3.0.x's getMapSizesByExecutorId cannot address a part
        of the mappers; 3.1.0 can (AQE's skew-split reads)."""
        return False

    def get_map_sizes(self, registry, shuffle_id: int,
                      start_map: int, end_map: Optional[int],
                      start_part: int, end_part: int):
        """Map output sizes of a reducer range (reference
        `getMapSizesByExecutorId`): [(map_id, part_id, size_bytes)] of
        the non-empty blocks in range."""
        statuses = registry.outputs_for(shuffle_id)
        all_maps = (max(statuses) + 1) if statuses else 0
        hi = all_maps if end_map is None else end_map
        if (start_map, hi) != (0, all_maps) \
                and not self.supports_map_index_ranges():
            raise NotImplementedError(
                f"Spark {self.version} cannot fetch partial mapper ranges")
        out = []
        for map_id in range(start_map, hi):
            if map_id not in statuses:
                continue
            sizes = statuses[map_id].partition_sizes
            for part_id in range(start_part, end_part):
                if sizes[part_id] > 0:
                    out.append((map_id, part_id, sizes[part_id]))
        return out

    def aqe_shuffle_reader_name(self) -> str:
        """The AQE shuffle reader's name in this version (upstream's
        CustomShuffleReaderExec; Databricks forked its own)."""
        return "CustomShuffleReaderExec"

    def make_query_stage_prep_rule(self, conf, factory):
        """The AQE query-stage prep rule of this version, built from the
        session's conf (Databricks wraps it under its fork's name)."""
        return factory(conf)

    # -- join construction drift --------------------------------------------
    BUILD_LEFT = "left"
    BUILD_RIGHT = "right"

    def build_side_of(self, join_type, preferred: str = "right") -> str:
        """The build side (reference `getBuildSide`: BuildLeft and
        BuildRight moved packages in 3.1, so the engine asks the shim).
        Semi and anti joins always build the right side."""
        from spark_rapids_tpu_torch.exec.joins import JoinType as JT
        if join_type in (JT.LEFT_SEMI, JT.LEFT_ANTI):
            return self.BUILD_RIGHT
        return preferred

    def make_broadcast_exchange(self, child):
        """Broadcast exchange constructor (reference
        `getGpuBroadcastExchangeExec`; 3.1 wraps BroadcastExchangeLike)."""
        from spark_rapids_tpu_torch.shuffle.exchange import \
            BroadcastExchangeExec
        return BroadcastExchangeExec(child)

    # -- rule extensions ----------------------------------------------------
    def extra_exec_rules(self) -> dict:
        """Per-version exec rules on top of the common set (reference
        `SparkShims.getExecs`)."""
        return {}

    def extra_expr_rules(self) -> dict:
        return {}

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
