"""Replacement-rule registry and the plan-rewrite entry points (port of
spark_rapids_tpu/plan/overrides.py; the reference plugin's
`GpuOverrides`).

`accelerate(cpu_plan, conf, device)` is the pipeline: column pruning ->
wrap -> tag (bottom-up) -> explain -> convert -> transitions (bridges,
pair elimination) -> fusion -> coalesce insertion -> the test-mode
check.  Conversion plans too: an aggregate over several partitions
becomes partial -> exchange -> final, a global sort over several
partitions a range exchange under the sort, a join over several
partitions hash exchanges of both sides on their keys, and a global
limit over a global sort a top-N.  `collect(plan, conf)`
runs the result to a pandas DataFrame.

Only rules for what the port has are registered: any other node or
expression is tagged "will not work" with its reason and stays on the
CPU engine (plan/nodes.py).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import AggMode, HashAggregateExec
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.joins import HashJoinExec, JoinType
from spark_rapids_tpu_torch.exec.sort import SortedTopNExec, SortExec
from spark_rapids_tpu_torch.exprs.base import Alias, Expression, col
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.meta import PlanMeta, wrap_plan
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partitioning import (HashPartitioning,
                                                         RangePartitioning,
                                                         SinglePartitioning)

log = logging.getLogger("spark_rapids_tpu_torch.plan")


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExprRule:
    """Per-expression replacement rule: the expression AST is shared by
    both engines, so the rule carries tagging knowledge only."""
    name: str
    desc: str


@dataclasses.dataclass
class ExecRule:
    cpu_class: type
    desc: str
    convert: Callable[[PlanMeta, list[TpuExec]], TpuExec]
    exprs_of: Callable[[N.CpuNode], Sequence[Expression]] = lambda n: ()
    tag_extra: Optional[Callable] = None


EXPR_RULES: dict[str, ExprRule] = {}
EXEC_RULES: dict[type, ExecRule] = {}


def expr(name: str, desc: str) -> None:
    EXPR_RULES[name] = ExprRule(name, desc)


def register_exec(cpu_class, desc, convert, exprs_of=lambda n: (),
                  tag_extra=None) -> None:
    EXEC_RULES[cpu_class] = ExecRule(cpu_class, desc, convert, exprs_of,
                                     tag_extra)


def expr_rule_for(e: Expression) -> Optional[ExprRule]:
    return EXPR_RULES.get(type(e).__name__)


def exec_rule_for(node: N.CpuNode) -> Optional[ExecRule]:
    return EXEC_RULES.get(type(node))


# the expressions the port implements on the device
for _name in """
AttributeReference BoundReference Literal Alias
Add Subtract Multiply Divide IntegralDivide Remainder Pmod UnaryMinus
UnaryPositive Abs
EqualTo LessThan LessThanOrEqual GreaterThan GreaterThanOrEqual
And Or Not
If CaseWhen Coalesce NullIf Nvl2 AtLeastNNonNulls NaNvl
Year Month DayOfMonth DayOfWeek DayOfYear Quarter WeekOfYear LastDay
DateAdd DateSub DateDiff AddMonths
Length Substring Contains StartsWith EndsWith Like
Sum Count Average
""".split():
    expr(_name, f"GPU implementation of {_name}")

# the aggregate functions both engines implement
_SUPPORTED_AGGS = set(N._AGG_PANDAS)


def _tag_aggregate(meta) -> None:
    """Aggregate-function checks: registry membership, and float Sum/
    Average, whose result varies with evaluation order, gated on
    spark.rapids.sql.variableFloatAgg.enabled."""
    node = meta.node
    child_schema = node.child.output_schema()
    for a in node.aggregates:
        fname = type(a.func).__name__
        if fname not in _SUPPORTED_AGGS:
            meta.will_not_work_on_gpu(
                f"aggregate function {fname} has no GPU implementation")
            continue
        if fname in ("Average", "Sum") and a.func.child is not None \
                and not meta.conf[C.VARIABLE_FLOAT_AGG]:
            try:
                dt = a.func.child.data_type(child_schema)
            except Exception:
                continue
            if dt.is_floating:
                meta.will_not_work_on_gpu(
                    f"float {fname} varies with evaluation order; enable "
                    f"with {C.VARIABLE_FLOAT_AGG.key}")


# ---------------------------------------------------------------------------
# exec converters
def _conv_source(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    node: N.CpuSource = meta.node
    schema = node.output_schema()
    parts = [[batch_from_df(df, schema, meta.device)] if len(df) else []
             for df in node.partitions]
    return B.LocalBatchSource(parts, schema, device=meta.device)


def _conv_project(meta, kids) -> TpuExec:
    return B.ProjectExec(meta.node.exprs, kids[0])


def _conv_filter(meta, kids) -> TpuExec:
    return B.FilterExec(meta.node.condition, kids[0])


def _conv_limit(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.exec.limit import (GlobalLimitExec,
                                                   LocalLimitExec)
    node: N.CpuLimit = meta.node
    child = kids[0]
    if node.global_limit:
        # ORDER BY + LIMIT -> top-N (Spark plans this shape as
        # TakeOrderedAndProjectExec): prune each batch to n candidates,
        # then sort the merged candidates exactly
        if (isinstance(child, SortExec) and child.global_sort and
                node.n <= 1 << 14):
            src = child.child
            if (isinstance(src, ShuffleExchangeExec) and
                    isinstance(src.partitioning, RangePartitioning)):
                # the range exchange only existed to order the
                # partitions totally; top-N prunes each partition instead
                src = src.child
            return SortedTopNExec(node.n, child.order, src)
        return GlobalLimitExec(node.n, LocalLimitExec(node.n, child))
    return LocalLimitExec(node.n, child)


def _conv_sort(meta, kids) -> TpuExec:
    node: N.CpuSort = meta.node
    if not node.global_sort:
        return SortExec(node.order, kids[0], global_sort=False)
    nparts = kids[0].output_partition_count()
    if nparts > 1:
        # total order: range exchange, then the sort
        ex = ShuffleExchangeExec(RangePartitioning(node.order, nparts),
                                 kids[0])
        return SortExec(node.order, ex, global_sort=True)
    return SortExec(node.order, kids[0], global_sort=True)


def _conv_aggregate(meta, kids) -> TpuExec:
    node: N.CpuAggregate = meta.node
    child = kids[0]
    nparts = child.output_partition_count()
    if nparts <= 1:
        return HashAggregateExec(node.group_exprs, node.aggregates, child,
                                 AggMode.COMPLETE)
    # distributed: partial -> key exchange -> final
    partial = HashAggregateExec(node.group_exprs, node.aggregates, child,
                                AggMode.PARTIAL)
    fields = partial.output_schema().fields
    if node.group_exprs:
        keys = [col(f.name) for f in fields[:len(node.group_exprs)]]
        # a final aggregation needs key clustering only, so a small
        # partial output may skip the split
        ex = ShuffleExchangeExec(HashPartitioning(keys, nparts), partial,
                                 coalesce_small=True)
    else:
        ex = ShuffleExchangeExec(SinglePartitioning(), partial)
    return HashAggregateExec(
        [Alias(col(f.name), f.name)
         for f in fields[:len(node.group_exprs)]],
        node.aggregates, ex, AggMode.FINAL)


def _conv_hash_join(meta, kids) -> TpuExec:
    node: N.CpuHashJoin = meta.node
    left, right = kids
    nparts = max(left.output_partition_count(),
                 right.output_partition_count())
    if nparts > 1:
        # co-partition both sides by their keys
        left = ShuffleExchangeExec(
            HashPartitioning(node.left_keys, nparts), left)
        right = ShuffleExchangeExec(
            HashPartitioning(node.right_keys, nparts), right)
    return HashJoinExec(node.join_type, node.left_keys, node.right_keys,
                        left, right, node.condition)


def _tag_join(meta) -> None:
    node: N.CpuHashJoin = meta.node
    if node.broadcast:
        # neither a device lane nor a quiet CPU island: the broadcast
        # exchange and its join come with the distribution work
        raise NotImplementedError(
            "BroadcastHashJoinExec is not ported yet (ROADMAP.md §1 item 8, "
            "shuffle and distribution)")
    supported = {JoinType.INNER, JoinType.LEFT_OUTER, JoinType.RIGHT_OUTER,
                 JoinType.FULL_OUTER, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
                 JoinType.CROSS}
    if node.join_type not in supported:
        meta.will_not_work_on_gpu(
            f"join type {node.join_type} not supported on GPU")
    if node.condition is not None and node.join_type not in (
            JoinType.INNER, JoinType.CROSS):
        meta.will_not_work_on_gpu(
            "residual join condition only supported for inner joins")


register_exec(N.CpuSource, "in-memory source", _conv_source)
register_exec(N.CpuProject, "projection", _conv_project,
              exprs_of=lambda n: n.exprs)
register_exec(N.CpuFilter, "filtering", _conv_filter,
              exprs_of=lambda n: [n.condition])
register_exec(N.CpuLimit, "row limit", _conv_limit)
register_exec(N.CpuSort, "sorting", _conv_sort,
              exprs_of=lambda n: [o.expr for o in n.order])
register_exec(
    N.CpuAggregate, "hash aggregation", _conv_aggregate,
    exprs_of=lambda n: list(n.group_exprs) + [
        a.func.child for a in n.aggregates if a.func.child is not None],
    tag_extra=_tag_aggregate)
register_exec(
    N.CpuHashJoin, "hash join", _conv_hash_join,
    exprs_of=lambda n: list(n.left_keys) + list(n.right_keys) +
    ([n.condition] if n.condition is not None else []),
    tag_extra=_tag_join)


# ---------------------------------------------------------------------------
def accelerate(cpu_plan: N.CpuNode, conf: Optional[C.RapidsConf] = None,
               device="cuda"):
    """The full rewrite: a TpuExec (fully accelerated), a CpuNode tree
    with device islands (partly), or the plan itself (sql disabled).
    Sources upload to `device`; device="cuda" without a card raises."""
    conf = conf or C.get_active_conf()
    dev = resolve_device(device)
    if not conf[C.SQL_ENABLED]:
        return cpu_plan
    from spark_rapids_tpu_torch.exec.base import TargetSize
    from spark_rapids_tpu_torch.plan.fusion import fuse_plan
    from spark_rapids_tpu_torch.plan.transitions import (
        _coalesce_cpu_islands, _optimize_tpu, assert_is_on_tpu,
        insert_coalesce, optimize_transitions)
    if conf[C.PRUNE_COLUMNS]:
        from spark_rapids_tpu_torch.plan.pruning import prune_columns
        cpu_plan = prune_columns(cpu_plan)
    with C.session(conf):
        meta = wrap_plan(cpu_plan, conf, device=dev)
        meta.tag_for_gpu()
        explain_mode = conf[C.EXPLAIN]
        if explain_mode != "NONE":
            text = meta.explain(all_nodes=(explain_mode == "ALL"))
            if text:
                log.warning("GPU plan overrides:\n%s", text)
        plan = meta.convert_if_needed()
        if isinstance(plan, TpuExec):
            plan = _optimize_tpu(plan)
            # fusion BEFORE coalesce insertion: chains must still be
            # adjacent
            plan = fuse_plan(plan, conf)
            plan = insert_coalesce(plan, conf)
        else:
            plan = optimize_transitions(plan)
            plan = fuse_plan(plan, conf)
            _coalesce_cpu_islands(plan, TargetSize(conf[C.BATCH_SIZE_BYTES]),
                                  conf[C.MAX_BATCH_ROWS])
    if conf[C.TEST_ENABLED]:
        allowed = frozenset(s for s in
                            str(conf[C.TEST_ALLOWED_NONGPU]).split(",") if s)
        assert_is_on_tpu(plan, allowed)
    plan._session_conf = conf
    plan._meta = meta
    return plan


def collect(plan, conf: Optional[C.RapidsConf] = None):
    """Run an accelerated (or partly accelerated) plan to a pandas
    DataFrame under its session conf."""
    conf = conf or getattr(plan, "_session_conf", None) or \
        C.get_active_conf()
    with C.session(conf):
        return _collect(plan)


def _collect(plan):
    """The deopt-and-retry boundary of PARTLY accelerated plans: a
    device->CPU transition inside the plan may raise FastPathInvalid
    from a deferred fast-path check; the fast paths at fault are
    disabled and the (pure) plan runs once more with every fast path
    off.  A fully accelerated plan retries inside TpuExec.collect."""
    from spark_rapids_tpu_torch.utils import checks as CK
    mark = CK.snapshot()
    try:
        return _collect_inner(plan)
    except CK.FastPathInvalid as e:
        e.recover_all()
        CK.drain_since(mark)
        CK.set_retrying(True)
        try:
            return _collect_inner(plan)
        finally:
            CK.set_retrying(False)


def _collect_inner(plan):
    if isinstance(plan, TpuExec):
        from spark_rapids_tpu_torch.plan.transitions import df_from_batch
        return df_from_batch(plan.collect())
    from spark_rapids_tpu_torch.exec.base import new_execution
    new_execution()
    return plan.collect()
