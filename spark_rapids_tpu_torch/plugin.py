"""Plugin entry and lifecycle (port of spark_rapids_tpu/plugin.py;
reference `SQLPlugin.scala:28`, `Plugin.scala:50-237`).

Spark's PluginContainer drives three hooks:

* `SQLPlugin`: the `spark.plugins=...` entry, which returns a driver
  plugin and an executor plugin.
* `DriverPlugin.init`: fixes up the session's settings (adds the SQL
  extension, checks the serializer) and returns the `spark.rapids.*` map
  Spark ships to every executor (`Plugin.scala:68-112`).
* `ExecutorPlugin.init`: brings up the port's `ResourceEnv` on the card
  (device manager, device -> host -> disk spill chain, task semaphore).
  A failure raises `ExecutorInitError`, which the embedder treats as
  fatal to the process (the reference calls System.exit); it never
  carries on on the CPU.

`activate()` is the local-mode bring-up that plays both roles in this
process, on the card unless the caller passes device="cpu"; without a
card it raises.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.memory.env import ResourceEnv

log = logging.getLogger(__name__)

_SQL_EXTENSION = "spark_rapids_tpu_torch.plugin.SQLExecPlugin"
_KRYO_REGISTRATOR = "spark_rapids_tpu_torch.plugin.TpuKryoRegistrator"


class ExecutorInitError(RuntimeError):
    """Executor bring-up failed.  The reference calls `System.exit(1)`
    (`Plugin.scala:132-139`) so that Spark replaces the executor; an
    embedder treats this exception as fatal to the process the same
    way."""


def fixup_configs(spark_conf: dict) -> dict:
    """Driver-side settings surgery (reference
    `RapidsPluginUtils.fixupConfigs`): add the SQL extension that
    installs the columnar override rules, and the serializer's
    registrator, so broadcast batches round-trip."""
    out = dict(spark_conf)
    exts = [e for e in str(out.get("spark.sql.extensions", "")).split(",")
            if e]
    if _SQL_EXTENSION not in exts:
        exts.append(_SQL_EXTENSION)
    out["spark.sql.extensions"] = ",".join(exts)

    serializer = out.get("spark.serializer", "")
    if "KryoSerializer" in serializer:
        regs = [r for r in
                str(out.get("spark.kryo.registrator", "")).split(",") if r]
        if _KRYO_REGISTRATOR not in regs:
            regs.append(_KRYO_REGISTRATOR)
        out["spark.kryo.registrator"] = ",".join(regs)
    elif serializer and "JavaSerializer" not in serializer:
        raise ValueError(
            f"spark.serializer={serializer} is not supported (only the "
            "Java and Kryo serializers are, as in the reference's "
            "Plugin.scala:90-98)")
    return out


def _rapids_conf_map(spark_conf: dict) -> dict:
    """What the driver ships to the executors: the spark.rapids.* keys."""
    return {k: v for k, v in spark_conf.items()
            if k.startswith("spark.rapids.")}


class DriverPlugin:
    """Reference `RapidsDriverPlugin` (`Plugin.scala:106-112`)."""

    def __init__(self):
        self.conf: Optional[C.RapidsConf] = None

    def init(self, spark_conf: dict) -> dict:
        fixed = fixup_configs(spark_conf)
        spark_conf.clear()
        spark_conf.update(fixed)
        self.conf = C.RapidsConf(dict(spark_conf))
        return _rapids_conf_map(spark_conf)


class ExecutorPlugin:
    """Reference `RapidsExecutorPlugin` (`Plugin.scala:117-146`)."""

    def __init__(self):
        self.env: Optional[ResourceEnv] = None

    def init(self, extra_conf: dict, hbm_total: Optional[int] = None,
             spill_dir: Optional[str] = None, device="cuda") -> None:
        try:
            conf = C.RapidsConf(dict(extra_conf))
            self.env = ResourceEnv.init(conf, hbm_total=hbm_total,
                                        spill_dir=spill_dir, device=device)
            TpuKryoRegistrator.register_all(self.env.device)
            # only a conf that brought the executor up becomes active
            C.set_active_conf(conf)
        except Exception as e:  # noqa: BLE001 - a failed bring-up is fatal
            log.error("Exception in the executor plugin: %s", e)
            raise ExecutorInitError(str(e)) from e

    def shutdown(self) -> None:
        if self.env is not None:
            ResourceEnv.shutdown()
            self.env = None


class SQLPlugin:
    """`spark.plugins` entry (reference `SQLPlugin.scala:28`)."""

    def driver_plugin(self) -> DriverPlugin:
        return DriverPlugin()

    def executor_plugin(self) -> ExecutorPlugin:
        return ExecutorPlugin()


class SQLExecPlugin:
    """Session-extension hook (reference `Plugin.scala:50-57`): installs
    the columnar override rules (pre: the plan rewrite; post: the
    transitions) and the AQE query-stage prep rule."""

    @staticmethod
    def apply(extensions: "SparkSessionExtensions", device="cuda") -> None:
        extensions.inject_columnar(
            lambda conf: _ColumnarOverrideRules(conf, device))

        def _prep_builder(conf):
            # the shim is resolved when the rule is built: apply() may
            # run before the session's conf is active on this thread,
            # and the builder gets the session's own conf
            from spark_rapids_tpu_torch.shims import current_shims
            return current_shims(conf).make_query_stage_prep_rule(
                conf, _query_stage_prep)
        extensions.inject_query_stage_prep_rule(_prep_builder)


class SparkSessionExtensions:
    """The part of Spark's `SparkSessionExtensions` the plugin uses."""

    def __init__(self):
        self.columnar_rules: list[Callable] = []
        self.query_stage_prep_rules: list[Callable] = []

    def inject_columnar(self, builder: Callable) -> None:
        self.columnar_rules.append(builder)

    def inject_query_stage_prep_rule(self, builder: Callable) -> None:
        self.query_stage_prep_rules.append(builder)


class _ColumnarOverrideRules:
    """The pre/post columnar transition rules (`Plugin.scala:38-45`)."""

    def __init__(self, conf: C.RapidsConf, device="cuda"):
        self.conf = conf
        self.device = device

    def pre_columnar_transitions(self, plan):
        from spark_rapids_tpu_torch.plan.overrides import accelerate
        return accelerate(plan, self.conf, self.device)

    def post_columnar_transitions(self, plan):
        return plan  # accelerate() already ran the transition pass


def _query_stage_prep(conf: C.RapidsConf):
    from spark_rapids_tpu_torch.plan.aqe import query_stage_prep
    return lambda plan: query_stage_prep(plan, conf)


class TpuKryoRegistrator:
    """Serializers of the broadcast and shuffle payload classes
    (reference `GpuKryoRegistrator.scala:34`): class -> (serialize,
    deserialize) over the port's host wire format (`columnar/serde.py`).
    A batch deserializes onto the device the executor was brought up
    on."""

    _registry: dict[type, tuple[Callable, Callable]] = {}
    _lock = threading.Lock()

    @classmethod
    def register(cls, klass: type, ser: Callable, deser: Callable) -> None:
        with cls._lock:
            cls._registry[klass] = (ser, deser)

    @classmethod
    def lookup(cls, klass: type) -> Optional[tuple[Callable, Callable]]:
        for base in klass.__mro__:
            hit = cls._registry.get(base)
            if hit is not None:
                return hit
        return None

    @classmethod
    def serialize(cls, obj: Any) -> bytes:
        hit = cls.lookup(type(obj))
        if hit is None:
            raise TypeError(f"no serializer registered for {type(obj)}")
        return hit[0](obj)

    @classmethod
    def deserialize(cls, klass: type, blob: bytes) -> Any:
        hit = cls.lookup(klass)
        if hit is None:
            raise TypeError(f"no serializer registered for {klass}")
        return hit[1](blob)

    @classmethod
    def register_all(cls, device="cuda") -> None:
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        from spark_rapids_tpu_torch.columnar.serde import (deserialize_batch,
                                                           serialize_batch)
        cls.register(ColumnarBatch, serialize_batch,
                     lambda blob: deserialize_batch(blob, device))


# ---------------------------------------------------------------------------
_ACTIVE: dict = {}
_ACTIVE_LOCK = threading.Lock()


def activate(settings: Optional[dict] = None,
             hbm_total: Optional[int] = None,
             spill_dir: Optional[str] = None,
             device="cuda") -> C.RapidsConf:
    """Local-mode bring-up: the driver plugin's settings fix-up and the
    executor plugin's resource bring-up in this process (driver and
    executor are one process in Spark's local mode), the session
    extension installed, and the resulting conf made active.  Runs on
    the card; device="cuda" without one raises ExecutorInitError."""
    with _ACTIVE_LOCK:
        spark_conf = dict(settings or {})
        driver = DriverPlugin()
        driver.init(spark_conf)  # fixes spark_conf up in place
        executor = ExecutorPlugin()
        # local mode: the executor sees the whole fixed-up conf (a
        # cluster would ship only the spark.rapids.* map)
        executor.init(spark_conf, hbm_total=hbm_total, spill_dir=spill_dir,
                      device=device)
        extensions = SparkSessionExtensions()
        SQLExecPlugin.apply(extensions, executor.env.device)
        _ACTIVE.update(driver=driver, executor=executor,
                       extensions=extensions)
        return C.get_active_conf()


def active_extensions() -> Optional[SparkSessionExtensions]:
    """The session extensions of the active plugin, if any."""
    with _ACTIVE_LOCK:
        return _ACTIVE.get("extensions")


def deactivate() -> None:
    with _ACTIVE_LOCK:
        executor = _ACTIVE.pop("executor", None)
        if executor is not None:
            executor.shutdown()
        _ACTIVE.clear()
        C.set_active_conf(C.RapidsConf())
