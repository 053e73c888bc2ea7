"""Shim discovery (port of spark_rapids_tpu/shims/loader.py): providers
register here, and a session's shims are the provider whose version
names hold the session's Spark version exactly, with the Databricks
sniff.  An unknown version fails unless
spark.rapids.tpu.allowUnknownSparkVersion lets it fall back to the
nearest patch release of its minor line."""
from __future__ import annotations

import logging
import re
import threading
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.shims.base import SparkShims
from spark_rapids_tpu_torch.shims.versions import ALL_SHIMS

log = logging.getLogger(__name__)

_PROVIDERS: list[type] = list(ALL_SHIMS)
_lock = threading.Lock()
_cache: dict[str, SparkShims] = {}


def register_provider(shim_class: type) -> None:
    """Add an externally defined shim provider, ahead of the built-in
    ones, so it may override a built-in version."""
    with _lock:
        _PROVIDERS.insert(0, shim_class)
        _cache.clear()


def _has_provider(version: str) -> bool:
    with _lock:
        return any(version in p.VERSION_NAMES for p in _PROVIDERS)


def detect_version(conf: Optional[C.RapidsConf] = None) -> str:
    """The session's Spark version.  The Databricks cluster-tag conf
    marks a Databricks runtime whatever base version it reports, but
    only when a Databricks shim for that base exists; otherwise the
    upstream shim serves it."""
    conf = conf or C.get_active_conf()
    version = str(conf[C.SPARK_VERSION])
    if conf.get("spark.databricks.clusterUsageTags.clusterId") \
            and "databricks" not in version:
        db = f"{version}-databricks"
        if _has_provider(db):
            return db
        log.warning(
            "Databricks runtime detected but no %s shim exists; "
            "using the upstream %s shim", db, version)
    return version


def _nearest_minor(version: str) -> Optional[str]:
    """The highest known patch release of the same major.minor line (an
    unknown 3.0.9 -> 3.0.2); Databricks versions never cross-match."""
    if "databricks" in version:
        return None
    parts = version.split(".")
    if len(parts) < 2:
        return None
    prefix = ".".join(parts[:2]) + "."
    with _lock:
        known = [v for p in _PROVIDERS for v in p.VERSION_NAMES
                 if v.startswith(prefix) and "databricks" not in v]
    if not known:
        return None
    # numeric order: lexicographic would rank 3.0.2 above 3.0.10
    return max(known, key=lambda v: [int(x) for x in re.findall(r"\d+", v)])


def get_spark_shims(version: Optional[str] = None,
                    conf: Optional[C.RapidsConf] = None) -> SparkShims:
    conf = conf or C.get_active_conf()
    version = version or detect_version(conf)
    allow = conf[C.ALLOW_UNKNOWN_SPARK_VERSION]
    with _lock:
        hit = _cache.get(version)
        if hit is None and allow:
            # a fallback lives under a gated key (see below)
            hit = _cache.get(version + "|fallback")
        if hit is not None:
            return hit
        for provider in _PROVIDERS:
            if version in provider.VERSION_NAMES:
                shims = _cache[version] = provider()
                return shims
    near = _nearest_minor(version)
    if near is not None and allow:
        log.warning(
            "No shim provider for Spark %s; %s is set: falling back to "
            "the %s shim, whose version-sensitive behaviors may be wrong "
            "for %s.", version, C.ALLOW_UNKNOWN_SPARK_VERSION.key, near,
            version)
        shims = get_spark_shims(near)
        # under a fallback-only key: a later session with the gate unset
        # must still get the error
        with _lock:
            _cache[version + "|fallback"] = shims
        return shims
    hint = (f" (set {C.ALLOW_UNKNOWN_SPARK_VERSION.key} to fall back "
            f"to the {near} shim at your own risk)"
            if near is not None and not allow else "")
    raise RuntimeError(
        f"Could not find a shim provider for Spark version {version!r}; "
        f"supported: "
        f"{[v for p in _PROVIDERS for v in p.VERSION_NAMES]}{hint}")


def current_shims(conf: Optional[C.RapidsConf] = None) -> SparkShims:
    return get_spark_shims(conf=conf)
