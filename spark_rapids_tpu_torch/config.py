"""Typed configuration registry (port of spark_rapids_tpu/config.py, cut to
the keys TPC-H Q1's path reads).

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
    "Wide grouping key sets sort by two murmur3-derived words. Not "
    "ported yet: the port groups every key set lexicographically.")
PALLAS_Q1_FUSED_ENABLED = conf(
    "spark.rapids.tpu.pallas.q1Fused.enabled", True,
    "Use the fused Q1 kernel for STACKED multi-batch TPC-H Q1 steps "
    "(models.tpch.build_q1_fused_kernel); off, each batch runs the "
    "plain torch step.")


class RapidsConf:
    """Immutable snapshot of config values."""

    def __init__(self, settings: Optional[dict[str, Any]] = None):
        self._settings = dict(settings or {})

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
