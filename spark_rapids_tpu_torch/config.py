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


def _bool(s):
    return s if isinstance(s, bool) else str(s).lower() in ("true", "1", "yes")


def conf(key: str, default: Any, doc: str) -> ConfEntry:
    conv = {bool: _bool, int: int, float: float, str: str}[type(default)]
    entry = ConfEntry(key, default, doc, conv)
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
FUSION_ENABLED = conf(
    "spark.rapids.sql.fusion.enabled", True,
    "Collapse Project/Filter chains between pipeline breaks into one "
    "stage, and fold a chain that feeds a partial or complete "
    "aggregation into the aggregate's update lane.")
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
    "Route exchanges through the accelerated shuffle manager.  Not "
    "ported yet: an exchange raises NotImplementedError while it is on.")
MESH_EXCHANGE_ENABLED = conf(
    "spark.rapids.shuffle.meshExchange.enabled", True,
    "Route hash exchanges through a device-mesh all-to-all when a mesh "
    "is active.  Not ported yet: the port has no active mesh, so the "
    "local exchange lane runs.")

# --- expressions ------------------------------------------------------------
INCOMPATIBLE_OPS = conf(
    "spark.rapids.sql.incompatibleOps.enabled", False,
    "Enable operators producing results that differ slightly from Spark "
    "(the transcendental functions, whose last bit may differ from the "
    "JVM's).")
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


_active = threading.local()


def get_active_conf() -> RapidsConf:
    c = getattr(_active, "conf", None)
    if c is None:
        c = RapidsConf()
        _active.conf = c
    return c


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
