"""API-surface audit (port of spark_rapids_tpu/api_validation.py;
reference `api_validation/.../ApiValidation.scala:17-60` and
`auditAllVersions.sh`, which diff every Gpu exec's constructor against
the Spark exec it replaces, per supported Spark version).

The audit holds the port's replacement registry against its plan and
exec classes:

- every registered exec rule converts a real `CpuNode` subclass, and
  its converter takes (meta, children);
- every `CpuNode` subclass that is a physical operator has a rule, or is
  a known gap (plan infrastructure, the transitions);
- every device exec class implements the columnar protocol
  (`output_schema` and `execute_partitions`, the two stubs of
  `TpuExec` that raise);
- every expression rule names an `Expression` subclass that exists;
- each shim version loads and has the whole `SparkShims` surface.

`audit_all_versions()` returns one report per version; an empty
`problems` list means the surface is consistent.  `python -m
spark_rapids_tpu_torch.api_validation` prints them and exits 1 on a
problem.
"""
from __future__ import annotations

import dataclasses
import inspect

from spark_rapids_tpu_torch.plan import nodes as N


@dataclasses.dataclass
class AuditReport:
    version: str
    checked: int = 0
    problems: list = dataclasses.field(default_factory=list)

    def ok(self) -> bool:
        return not self.problems

    def __str__(self):
        head = (f"[{self.version}] {self.checked} checks, "
                f"{len(self.problems)} problems")
        return "\n".join([head] + [f"  - {p}" for p in self.problems])


#: CpuNode subclasses that have no device replacement on purpose: plan
#: infrastructure, not operators a user's plan holds
KNOWN_UNREPLACED = {"CpuNode", "_GroupedCpuNode"}

#: the device-exit transitions (CpuNodes over a device subtree)
TRANSITIONS = {"ColumnarToRowExec", "AcceleratedColumnarToRowExec"}

#: the SparkShims surface every shim provides (reference
#: `SparkShims.scala:57-136`)
SHIM_SURFACE = (
    "columnar_to_row_transition", "make_first_last",
    "shuffle_manager_class", "supports_map_index_ranges",
    "get_map_sizes", "aqe_shuffle_reader_name", "build_side_of",
    "make_broadcast_exchange", "make_shuffle_exchange",
    "make_nested_loop_join", "make_query_stage_prep_rule",
    "make_file_partitions", "plan_file_partitions",
    "copy_scan_with_small_file_opt", "parquet_rebase_read_key",
    "parquet_rebase_write_key", "extra_exec_rules", "extra_expr_rules",
)


def _port_subclasses(cls: type) -> list[type]:
    """The direct subclasses defined in the port (a caller's own
    subclasses, a test's stand-ins among them, are not its surface)."""
    return [c for c in cls.__subclasses__()
            if c.__module__.startswith("spark_rapids_tpu_torch.")]


def _subclasses(root: type) -> list[type]:
    out = []

    def walk(cls):
        out.append(cls)
        for sub in _port_subclasses(cls):
            walk(sub)
    walk(root)
    return out


#: the packages whose modules define plan nodes and execs
_EXEC_PACKAGES = ("exec", "io", "plan", "pyudf", "shuffle")


def _import_exec_modules() -> None:
    """Every module that defines a CpuNode or a TpuExec, so the audit
    sees the same classes whatever the process imported before."""
    import importlib
    import pkgutil
    for name in _EXEC_PACKAGES:
        pkg = importlib.import_module(f"spark_rapids_tpu_torch.{name}")
        for mod in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{pkg.__name__}.{mod.name}")


def _all_cpu_nodes() -> list[type]:
    _import_exec_modules()
    return _subclasses(N.CpuNode)


def audit_exec_rules(report: AuditReport) -> None:
    from spark_rapids_tpu_torch.plan.overrides import EXEC_RULES
    for cls in _all_cpu_nodes():
        report.checked += 1
        if cls in EXEC_RULES or inspect.isabstract(cls) \
                or cls.__name__ in KNOWN_UNREPLACED | TRANSITIONS:
            continue
        report.problems.append(
            f"CpuNode {cls.__name__} has no exec replacement rule")
    for cls, rule in EXEC_RULES.items():
        report.checked += 1
        if not issubclass(cls, N.CpuNode):
            report.problems.append(
                f"exec rule registered for non-CpuNode {cls!r}")
        if not callable(rule.convert):
            report.problems.append(
                f"exec rule for {cls.__name__}: converter not callable")
            continue
        try:
            sig = inspect.signature(rule.convert)
        except (TypeError, ValueError):
            continue
        required = [p for p in sig.parameters.values()
                    if p.default is p.empty
                    and p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD)]
        if len(required) > 2:
            report.problems.append(
                f"exec rule for {cls.__name__}: converter must accept "
                f"(meta, children), got {sig}")


def audit_expr_rules(report: AuditReport) -> None:
    import importlib
    import pkgutil

    import spark_rapids_tpu_torch.exprs as E
    from spark_rapids_tpu_torch.plan.overrides import EXPR_RULES
    for mod in pkgutil.iter_modules(E.__path__):
        importlib.import_module(f"spark_rapids_tpu_torch.exprs.{mod.name}")
    from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
    from spark_rapids_tpu_torch.exprs.base import Expression
    known = {c.__name__ for root in (Expression, AggregateFunction)
             for c in _subclasses(root)}
    for name in EXPR_RULES:
        report.checked += 1
        if name not in known:
            report.problems.append(
                f"expression rule {name!r} names no Expression subclass")


def audit_tpu_exec_protocol(report: AuditReport) -> None:
    """Every instantiable (leaf) exec overrides the raising stubs of the
    columnar protocol; getattr alone always finds the stubs, so the
    check compares against them."""
    from spark_rapids_tpu_torch.exec.base import TpuExec
    _import_exec_modules()
    #: placeholders that carry a schema only and never execute
    exempt = {"SchemaOnlyExec"}
    for cls in _subclasses(TpuExec):
        if _port_subclasses(cls) or cls is TpuExec \
                or cls.__name__ in exempt:
            continue  # intermediate bases are not audited
        report.checked += 1
        for method in ("output_schema", "execute_partitions"):
            fn = getattr(cls, method, None)
            if fn is None or fn is getattr(TpuExec, method):
                report.problems.append(
                    f"exec {cls.__name__} does not implement {method}")


def audit_shim_surface(report: AuditReport, shims) -> None:
    for name in SHIM_SURFACE:
        report.checked += 1
        if not callable(getattr(shims, name, None)):
            report.problems.append(
                f"shim {type(shims).__name__} missing {name}()")
    report.checked += 1
    try:
        shims.shuffle_manager_type()
    except (ImportError, AttributeError) as e:
        report.problems.append(
            f"shim {type(shims).__name__}: shuffle manager "
            f"{shims.shuffle_manager_class()} does not resolve: {e}")


def audit_version(version: str) -> AuditReport:
    from spark_rapids_tpu_torch.shims import get_spark_shims
    report = AuditReport(version)
    audit_shim_surface(report, get_spark_shims(version))
    audit_exec_rules(report)
    audit_expr_rules(report)
    audit_tpu_exec_protocol(report)
    return report


def audit_all_versions() -> list[AuditReport]:
    """`auditAllVersions.sh`: one report per supported version."""
    from spark_rapids_tpu_torch.shims import ALL_SHIMS
    return [audit_version(p.VERSION_NAMES[0]) for p in ALL_SHIMS]


if __name__ == "__main__":
    import sys
    reports = audit_all_versions()
    for r in reports:
        print(r)
    sys.exit(0 if all(r.ok() for r in reports) else 1)
