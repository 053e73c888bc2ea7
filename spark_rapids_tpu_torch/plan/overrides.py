"""Replacement-rule registry and the plan-rewrite entry points (port of
spark_rapids_tpu/plan/overrides.py; the reference plugin's
`GpuOverrides`).

`accelerate(cpu_plan, conf, device)` is the pipeline: column pruning ->
wrap -> tag (bottom-up) -> explain -> convert -> transitions (bridges,
pair elimination) -> fusion -> coalesce insertion -> the test-mode
check.  Conversion plans too: an aggregate over several partitions
becomes partial -> exchange -> final, a global sort over several
partitions a range exchange under the sort, a join over several
partitions hash exchanges of both sides on their keys, a window over
several partitions a hash exchange on its PARTITION BY keys (or one
partition), and a global limit over a global sort a top-N.
`collect(plan, conf)` runs the result to a pandas DataFrame.

Only rules for what the port has are registered: any other node or
expression is tagged "will not work" with its reason and stays on the
CPU engine (plan/nodes.py).  `ExecutionPlanCapture` names the last
plan's fallbacks for tests.
"""
from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Callable, Optional, Sequence

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import resolve_device
from spark_rapids_tpu_torch.exec import basic as B
from spark_rapids_tpu_torch.exec.aggregate import AggMode, HashAggregateExec
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.joins import (BroadcastHashJoinExec,
                                               HashJoinExec, JoinType)
from spark_rapids_tpu_torch.exec.sort import SortedTopNExec, SortExec
from spark_rapids_tpu_torch.exprs.base import Alias, Expression, col
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan.meta import PlanMeta, wrap_plan
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partitioning import (
    HashPartitioning, RangePartitioning, RoundRobinPartitioning,
    SinglePartitioning)

log = logging.getLogger("spark_rapids_tpu_torch.plan")


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExprRule:
    """Per-expression replacement rule: the expression AST is shared by
    both engines, so the rule carries tagging knowledge only."""
    name: str
    desc: str
    tag_extra: Optional[Callable] = None
    #: why the result may differ from Spark's; such an expression runs on
    #: the device only under spark.rapids.sql.incompatibleOps.enabled
    incompat: Optional[str] = None


@dataclasses.dataclass
class ExecRule:
    cpu_class: type
    desc: str
    convert: Callable[[PlanMeta, list[TpuExec]], TpuExec]
    exprs_of: Callable[[N.CpuNode], Sequence[Expression]] = lambda n: ()
    tag_extra: Optional[Callable] = None


EXPR_RULES: dict[str, ExprRule] = {}
EXEC_RULES: dict[type, ExecRule] = {}


def expr(name: str, desc: str, tag_extra=None, incompat=None) -> None:
    EXPR_RULES[name] = ExprRule(name, desc, tag_extra, incompat)


def register_exec(cpu_class, desc, convert, exprs_of=lambda n: (),
                  tag_extra=None) -> None:
    EXEC_RULES[cpu_class] = ExecRule(cpu_class, desc, convert, exprs_of,
                                     tag_extra)


def expr_rule_for(e: Expression) -> Optional[ExprRule]:
    return EXPR_RULES.get(type(e).__name__)


def exec_rule_for(node: N.CpuNode) -> Optional[ExecRule]:
    return EXEC_RULES.get(type(node))


# the expressions the port implements on the device (the reference's
# _SIMPLE_EXPRS less GroupRef, which the port's aggregate does not use)
for _name in """
AttributeReference BoundReference Literal Alias
Add Subtract Multiply Divide IntegralDivide Remainder Pmod UnaryMinus
UnaryPositive Abs
EqualTo EqualNullSafe LessThan LessThanOrEqual GreaterThan
GreaterThanOrEqual And Or Not IsNull IsNotNull IsNaN InSet
BitwiseAnd BitwiseOr BitwiseXor BitwiseNot ShiftLeft ShiftRight
ShiftRightUnsigned
If CaseWhen Coalesce NullIf Nvl2 AtLeastNNonNulls NaNvl
Year Month DayOfMonth DayOfWeek DayOfYear Quarter WeekOfYear LastDay
Hour Minute Second DateAdd DateSub DateDiff AddMonths MonthsBetween
UnixTimestamp FromUnixTime ToDate TruncDate
Sqrt Cbrt Exp Expm1 Log Log1p Log2 Log10 Rint Signum Ceil Floor Pow Round
MonotonicallyIncreasingID SparkPartitionID
NormalizeNaNAndZero KnownFloatingPointNormalized KnownNotNull
Length Upper Lower InitCap Substring StringTrim StringTrimLeft
StringTrimRight ConcatStrings Contains StartsWith EndsWith Like
StringLocate StringReplace LPad RPad
Sum Count Min Max First Last
Logarithm WeekDay ToUnixTimestamp TimeAdd
""".split():
    expr(_name, f"GPU implementation of {_name}")

# the transcendentals' last bit may differ from the JVM's StrictMath
for _name in ("Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
              "Tanh", "ToDegrees", "ToRadians", "Cot", "Acosh", "Asinh",
              "Atanh"):
    expr(_name, f"GPU implementation of {_name}",
         incompat="floating point results differ in ulp from the JVM")

expr("Rand", "per-row uniform random", incompat="the threefry stream "
     "differs from the JVM's XORShiftRandom")


def _tag_cast(m) -> None:
    """Per-direction cast gating: the gated directions format or parse
    in ways that may differ from the JVM's; ANSI runs only the numeric
    -> integral overflow checks."""
    e = m.expr
    src = None
    for schema in m.input_schemas():
        try:
            src = e.child.data_type(schema)
            break
        except KeyError:
            continue
    if src is None:
        return  # an unresolvable child type is left to other tagging
    dst = e.to
    if e.ansi and not (src.is_numeric and dst.is_numeric
                       and not dst.is_floating):
        m.will_not_work_on_gpu(
            "ANSI cast supported only for numeric -> integral overflow "
            "checks")
    if src.is_floating and dst.is_string and \
            not m.conf[C.CASTS_FLOAT_TO_STRING]:
        m.will_not_work_on_gpu(
            "float->string formatting differs from Java at extreme "
            f"exponents; enable with {C.CASTS_FLOAT_TO_STRING.key}")
    if src.is_string and dst.is_floating and \
            not m.conf[C.CASTS_STRING_TO_FLOAT]:
        m.will_not_work_on_gpu(
            "string->float parse may differ by 1 ulp from Java; enable "
            f"with {C.CASTS_STRING_TO_FLOAT.key}")
    if src.is_string and dst.id == T.TypeId.TIMESTAMP_US and \
            not m.conf[C.CASTS_STRING_TO_TS]:
        m.will_not_work_on_gpu(
            "string->timestamp supports canonical forms only; enable "
            f"with {C.CASTS_STRING_TO_TS.key}")


expr("Cast", "GPU implementation of Cast", tag_extra=_tag_cast)


def _tag_substring_index(m) -> None:
    d, n = m.expr.literal_args()
    if d is None or n is None:
        m.will_not_work_on_gpu(
            "substring_index delimiter and count must be literals")


def _consumer(m):
    """The expression that consumes m's, or None at a plan node."""
    return getattr(m.parent, "expr", None)


def _tag_string_split(m) -> None:
    """A split is evaluable only as split(s, d)[i] with a literal
    pattern free of regex metacharacters and a literal limit that is -1
    or positive."""
    from spark_rapids_tpu_torch.exprs.complex import GetArrayItem
    e = m.expr
    if not isinstance(_consumer(m), GetArrayItem):
        m.will_not_work_on_gpu(
            "split() result must be indexed (split(s,d)[i]); array "
            "columns are outside the type matrix")
    if e.literal_pattern() is None:
        m.will_not_work_on_gpu(
            "split pattern must be a literal without regex "
            "metacharacters")
    if e.literal_limit() in (None, 0):
        m.will_not_work_on_gpu(
            "split limit must be a literal -1 or positive")


def _tag_inline_only(consumer_name, consumer_cls):
    def tag(m):
        if not isinstance(_consumer(m), consumer_cls):
            m.will_not_work_on_gpu(
                f"{type(m.expr).__name__} must be consumed by "
                f"{consumer_name}; array/map columns are outside the type "
                "matrix")
    return tag


def _tag_get_array_item(m) -> None:
    from spark_rapids_tpu_torch.exprs.complex import CreateArray
    from spark_rapids_tpu_torch.exprs.string_fns import StringSplit
    if not isinstance(m.expr.child, (CreateArray, StringSplit)):
        m.will_not_work_on_gpu(
            "GetArrayItem supports inline arrays (split()/array()) only")


def _tag_get_map_value(m) -> None:
    from spark_rapids_tpu_torch.exprs.complex import CreateMap
    if not isinstance(m.expr.child, CreateMap):
        m.will_not_work_on_gpu("GetMapValue supports inline map(...) only")


def _register_complex_rules() -> None:
    from spark_rapids_tpu_torch.exprs.complex import (GetArrayItem,
                                                      GetMapValue)
    expr("SubstringIndex", "GPU implementation of SubstringIndex",
         tag_extra=_tag_substring_index)
    expr("StringSplit", "split into parts, consumed by []",
         tag_extra=_tag_string_split)
    expr("GetArrayItem", "index an inline array",
         tag_extra=_tag_get_array_item)
    expr("GetMapValue", "look up an inline map",
         tag_extra=_tag_get_map_value)
    expr("CreateArray", "inline array constructor",
         tag_extra=_tag_inline_only("GetArrayItem or explode",
                                    (GetArrayItem,)))
    expr("CreateMap", "inline map constructor",
         tag_extra=_tag_inline_only("GetMapValue", (GetMapValue,)))


_register_complex_rules()
expr("Average", "GPU average")

# the aggregate functions both engines implement
_SUPPORTED_AGGS = set(N._AGG_PANDAS)


def _tag_aggregate(meta) -> None:
    """Aggregate-function checks: registry membership, and float Sum,
    Average, StddevSamp and VarianceSamp, whose results vary with
    evaluation order, gated on spark.rapids.sql.variableFloatAgg.enabled."""
    node = meta.node
    child_schema = node.child.output_schema()
    for a in node.aggregates:
        fname = type(a.func).__name__
        if fname not in _SUPPORTED_AGGS:
            meta.will_not_work_on_gpu(
                f"aggregate function {fname} has no GPU implementation")
            continue
        if fname in ("Average", "Sum", "StddevSamp", "VarianceSamp") \
                and a.func.child is not None \
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
    src = B.LocalBatchSource(parts, schema, device=meta.device)
    # stable identity across plan rebuilds (the result cache's key): the
    # uploaded batches are new per accelerate(), the session's pandas
    # partitions are not
    src.source_identity = getattr(node, "source_identity", None) \
        or tuple(node.partitions)
    return src


def _conv_range(meta, kids) -> TpuExec:
    node: N.CpuRange = meta.node
    return B.RangeExec(node.start, node.end, node.step,
                       num_partitions=node.num_partitions,
                       device=meta.device)


def _conv_union(meta, kids) -> TpuExec:
    return B.UnionExec(*kids)


def _conv_expand(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.exec.expand import ExpandExec
    node: N.CpuExpand = meta.node
    return ExpandExec(node.projections, list(node.names), kids[0])


def _conv_generate(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.exec.expand import GenerateExec
    node: N.CpuGenerate = meta.node
    return GenerateExec(node.element_exprs, kids[0],
                        include_pos=node.include_pos,
                        value_name=node.value_name,
                        retained=node.retained)


def _conv_window(meta, kids) -> TpuExec:
    """A window over several partitions co-locates each window partition
    first: a hash exchange on the PARTITION BY keys (clustering only, so
    a small input may land whole in one partition), or one partition
    when there are none."""
    from spark_rapids_tpu_torch.exec.window import WindowExec
    node = meta.node
    child = kids[0]
    nparts = child.output_partition_count()
    if nparts > 1:
        if node.spec.partition_by:
            child = ShuffleExchangeExec(
                HashPartitioning(list(node.spec.partition_by), nparts),
                child, coalesce_small=True)
        else:
            child = ShuffleExchangeExec(SinglePartitioning(), child)
    return WindowExec(node.window_exprs, node.spec, child)


def _tag_window(meta) -> None:
    """Frame shapes and functions WindowExec does not evaluate stay on
    the CPU engine instead of failing at run time."""
    from spark_rapids_tpu_torch.exec.window import KINDS
    node = meta.node
    child_schema = node.child.output_schema()
    if not node.spec.frame.is_rows:
        if len(node.spec.order_by) != 1:
            meta.will_not_work_on_gpu(
                "range frames need exactly one order key on the GPU")
        else:
            # the exec reads the order key as int64: a float or string
            # key would be truncated into false peers
            try:
                dt = node.spec.order_by[0].expr.data_type(child_schema)
            except Exception:
                dt = None
            if dt is not None and not dt.is_integral:
                meta.will_not_work_on_gpu(
                    f"range frame order key must be integral/date/"
                    f"timestamp, got {dt}")
    for fn, _ in node.window_exprs:
        if fn.kind not in KINDS:
            meta.will_not_work_on_gpu(
                f"window function {fn.kind} has no GPU implementation")
        elif fn.kind in ("min", "max") and fn.child is not None:
            try:
                dt = fn.child.data_type(child_schema)
            except Exception:
                continue
            if dt.is_string:
                meta.will_not_work_on_gpu(
                    "string window min/max has no GPU implementation")


def _conv_project(meta, kids) -> TpuExec:
    return B.ProjectExec(meta.node.exprs, kids[0])


def _conv_filter(meta, kids) -> TpuExec:
    # a filter over a file scan is pushed into it for row-group pruning
    # (Spark's pushed filters); the FilterExec stays, for exactness
    from spark_rapids_tpu_torch.io.exec import TpuFileSourceScanExec
    if isinstance(kids[0], TpuFileSourceScanExec) and \
            kids[0].pushed_filter is None:
        kids[0].pushed_filter = meta.node.condition
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
        ex = ShuffleExchangeExec(
            HashPartitioning(keys, _exchange_partitions(nparts, meta.conf)),
            partial, coalesce_small=True)
    else:
        ex = ShuffleExchangeExec(SinglePartitioning(), partial)
    return HashAggregateExec(
        [Alias(col(f.name), f.name)
         for f in fields[:len(node.group_exprs)]],
        node.aggregates, ex, AggMode.FINAL)


def _exchange_partitions(nparts: int, conf: C.RapidsConf) -> int:
    """The partition count of a planned hash exchange: the mesh's size
    while a mesh is active and its exchange lane is on, so that slot d
    owns output partition d and the exchange routes through the mesh
    all-to-all (shuffle/exchange.py `_mesh_routable`)."""
    from spark_rapids_tpu_torch.parallel import mesh as PM
    active = PM.get_active_mesh()
    if active is not None and conf[C.MESH_EXCHANGE_ENABLED]:
        mesh, axis = active
        return mesh.shape[axis]
    return nparts


def _conv_hash_join(meta, kids) -> TpuExec:
    node: N.CpuHashJoin = meta.node
    left, right = kids
    if node.broadcast:
        # the build side (the left one of a RIGHT OUTER join) is
        # collected once and shared by every probe partition
        from spark_rapids_tpu_torch.shims import current_shims
        shims = current_shims(meta.conf)
        side = shims.build_side_of(
            node.join_type, shims.BUILD_LEFT
            if node.join_type == JoinType.RIGHT_OUTER else shims.BUILD_RIGHT)
        if side == shims.BUILD_LEFT:
            left = shims.make_broadcast_exchange(left)
        else:
            right = shims.make_broadcast_exchange(right)
        return BroadcastHashJoinExec(node.join_type, node.left_keys,
                                     node.right_keys, left, right,
                                     node.condition)
    nparts = max(left.output_partition_count(),
                 right.output_partition_count())
    if nparts > 1:
        # co-partition both sides by their keys
        nparts = _exchange_partitions(nparts, meta.conf)
        left = ShuffleExchangeExec(
            HashPartitioning(node.left_keys, nparts), left)
        right = ShuffleExchangeExec(
            HashPartitioning(node.right_keys, nparts), right)
    return HashJoinExec(node.join_type, node.left_keys, node.right_keys,
                        left, right, node.condition)


def _tag_join(meta) -> None:
    node: N.CpuHashJoin = meta.node
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


def _conv_nested_loop_join(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.shims import current_shims
    node: N.CpuNestedLoopJoin = meta.node
    return current_shims(meta.conf).make_nested_loop_join(
        node.join_type, kids[0], kids[1], node.condition,
        target_size_bytes=int(meta.conf[C.BATCH_SIZE_BYTES]))


def _tag_nested_loop_join(meta) -> None:
    """Reference `GpuOverrides.scala:1770-1789`: both brute-force join
    rules are disabled by default ('large joins can cause out of memory
    errors'); `GpuBroadcastNestedLoopJoinExec.scala:49-53` supports
    inner-like types only."""
    node: N.CpuNestedLoopJoin = meta.node
    name = type(node).__name__
    if not meta.conf.is_op_enabled("exec", name, default=False):
        meta.will_not_work_on_gpu(
            f"{name} is disabled by default (large joins can cause out "
            f"of memory errors); enable with "
            f"{C.op_enable_key('exec', name)}")
    if node.join_type not in (JoinType.INNER, JoinType.CROSS):
        meta.will_not_work_on_gpu(
            f"nested loop join type {node.join_type} is not supported "
            f"on the GPU (inner-like only)")


def _strip_smj_sort(kid: TpuExec, keys) -> TpuExec:
    """Drop a per-partition SortExec that is exactly the ordering a
    sort-merge join requires (its keys, ascending, in key order, default
    null ordering): it existed only to feed the merge being replaced.
    Any other sort, such as a user's descending sortWithinPartitions,
    stays."""
    from spark_rapids_tpu_torch.exprs.base import fingerprint
    if not isinstance(kid, SortExec) or kid.global_sort:
        return kid
    if len(kid.order) != len(keys):
        return kid
    for o, k in zip(kid.order, keys):
        if (not o.ascending or not o.resolved_nulls_first or
                fingerprint(o.expr) != fingerprint(k)):
            return kid
    return kid.child


def _conv_sort_merge_join(meta, kids) -> TpuExec:
    node: N.CpuSortMergeJoin = meta.node
    return _conv_hash_join(meta, [_strip_smj_sort(kids[0], node.left_keys),
                                  _strip_smj_sort(kids[1], node.right_keys)])


def _tag_sort_merge_join(meta) -> None:
    _tag_join(meta)
    if not meta.conf[C.REPLACE_SORT_MERGE_JOIN]:
        meta.will_not_work_on_gpu(
            "replacing SortMergeJoin disabled by "
            f"{C.REPLACE_SORT_MERGE_JOIN.key}")


_PART_OF_SPEC = {
    "hash": lambda s: HashPartitioning(list(s.exprs), s.num_partitions),
    "roundrobin": lambda s: RoundRobinPartitioning(s.num_partitions),
    "single": lambda s: SinglePartitioning(),
    "range": lambda s: RangePartitioning(list(s.order), s.num_partitions),
}


def _conv_shuffle(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.shims import current_shims
    node: N.CpuShuffleExchange = meta.node
    # a user's repartition keeps its partition count under 3.1's
    # ShuffleExchangeLike contract (the constructor drifts by version)
    return current_shims(meta.conf).make_shuffle_exchange(
        _PART_OF_SPEC[node.spec.kind](node.spec), kids[0],
        can_change_num_partitions=not node.user_specified)


def _conv_cached_columnar(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.plan.transitions import \
        HostColumnarToDeviceExec
    return HostColumnarToDeviceExec(meta.node, meta.device)


register_exec(N.CpuSource, "in-memory source", _conv_source)
register_exec(N.CpuRange, "range generation", _conv_range)
register_exec(N.CpuUnion, "union all", _conv_union)
register_exec(
    N.CpuExpand, "expand (grouping sets/rollup/cube)", _conv_expand,
    exprs_of=lambda n: [e for p in n.projections for e in p])
register_exec(
    N.CpuGenerate, "generate (inline-array explode)", _conv_generate,
    exprs_of=lambda n: list(n.element_exprs))
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
# a sort aggregate converts to the same hash aggregate (the GPU version
# always aggregates by hash)
register_exec(
    N.CpuSortAggregate, "sort aggregation (replaced with hash agg)",
    _conv_aggregate,
    exprs_of=lambda n: list(n.group_exprs) + [
        a.func.child for a in n.aggregates if a.func.child is not None],
    tag_extra=_tag_aggregate)
register_exec(
    N.CpuHashJoin, "hash join", _conv_hash_join,
    exprs_of=lambda n: list(n.left_keys) + list(n.right_keys) +
    ([n.condition] if n.condition is not None else []),
    tag_extra=_tag_join)
register_exec(
    N.CpuSortMergeJoin, "sort-merge join (replaced with hash join)",
    _conv_sort_merge_join,
    exprs_of=lambda n: list(n.left_keys) + list(n.right_keys) +
    ([n.condition] if n.condition is not None else []),
    tag_extra=_tag_sort_merge_join)
# the brute-force joins: registered as the reference's
# exec[BroadcastNestedLoopJoinExec] / exec[CartesianProductExec] pair
# (GpuOverrides.scala:1770-1789), both disabled by default
register_exec(
    N.CpuNestedLoopJoin, "join using brute force", _conv_nested_loop_join,
    exprs_of=lambda n: [n.condition] if n.condition is not None else [],
    tag_extra=_tag_nested_loop_join)
register_exec(
    N.CpuCartesianProduct, "cartesian product using brute force",
    _conv_nested_loop_join,
    exprs_of=lambda n: [n.condition] if n.condition is not None else [],
    tag_extra=_tag_nested_loop_join)
register_exec(N.CpuShuffleExchange, "shuffle exchange", _conv_shuffle,
              exprs_of=lambda n: list(n.spec.exprs) +
              [o.expr for o in n.spec.order])
register_exec(
    N.CpuCachedColumnar, "host-columnar cache upload (HostColumnarToGpu)",
    _conv_cached_columnar)


def _register_window_rule() -> None:
    from spark_rapids_tpu_torch.exec.window import CpuWindow
    register_exec(
        CpuWindow, "window aggregation", _conv_window,
        exprs_of=lambda n: (
            [fn.child for fn, _ in n.window_exprs if fn.child is not None]
            + list(n.spec.partition_by)
            + [o.expr for o in n.spec.order_by]),
        tag_extra=_tag_window)


_register_window_rule()


# --- I/O: the format enables, the CSV option guards and the rebase modes ---
_FORMAT_ENABLES = {
    "parquet": (C.PARQUET_ENABLED, C.PARQUET_READ_ENABLED,
                C.PARQUET_WRITE_ENABLED),
    "orc": (C.ORC_ENABLED, C.ORC_READ_ENABLED, C.ORC_WRITE_ENABLED),
    "csv": (C.CSV_ENABLED, C.CSV_READ_ENABLED, None),
}


def _tag_rebase(meta, write: bool) -> None:
    """LEGACY hybrid-calendar rebase runs on the CPU engine, which
    rebases; an unknown mode stays there too.  The key is
    version-variant, so it comes from the shims."""
    from spark_rapids_tpu_torch.io import rebase as RB
    from spark_rapids_tpu_torch.shims import current_shims
    shims = current_shims(meta.conf)
    if write:
        key = shims.parquet_rebase_write_key()
        mode = shims.parquet_rebase_write_mode(meta.conf)
    else:
        key = shims.parquet_rebase_read_key()
        mode = shims.parquet_rebase_read_mode(meta.conf)
    side = "write" if write else "read"
    if mode == "LEGACY":
        meta.will_not_work_on_gpu(
            f"legacy datetime rebase requested via {key}")
    elif mode not in RB.READ_MODES:
        meta.will_not_work_on_gpu(
            f"{mode} is not a supported {side} rebase mode")


def _tag_file_scan(meta) -> None:
    node = meta.node
    fmt = node.scan.file_format
    fmt_conf, read_conf, _ = _FORMAT_ENABLES[fmt]
    if not meta.conf[fmt_conf]:
        meta.will_not_work_on_gpu(
            f"{fmt} acceleration disabled by {fmt_conf.key}")
    elif not meta.conf[read_conf]:
        meta.will_not_work_on_gpu(
            f"{fmt} reads disabled by {read_conf.key}")
    if fmt == "csv":
        for reason in node.scan.reader.options.tag_unsupported():
            meta.will_not_work_on_gpu(f"CSV: {reason}")
    if fmt == "parquet":
        _tag_rebase(meta, write=False)


def _conv_file_scan(meta, kids) -> TpuExec:
    from spark_rapids_tpu_torch.io.exec import TpuFileSourceScanExec
    return TpuFileSourceScanExec(meta.node.scan, meta.node.pushed_filter,
                                 meta.conf, meta.device)


def _tag_write_files(meta) -> None:
    node = meta.node
    if node.file_format not in ("parquet", "orc"):
        meta.will_not_work_on_gpu(
            f"{node.file_format} writes have no GPU implementation")
        return
    fmt_conf, _, write_conf = _FORMAT_ENABLES[node.file_format]
    if not meta.conf[fmt_conf]:
        meta.will_not_work_on_gpu(
            f"{node.file_format} acceleration disabled by {fmt_conf.key}")
    elif not meta.conf[write_conf]:
        meta.will_not_work_on_gpu(
            f"{node.file_format} writes disabled by {write_conf.key}")
    if node.file_format == "parquet":
        _tag_rebase(meta, write=True)


def _conv_write_files(meta, kids) -> TpuExec:
    import copy

    from spark_rapids_tpu_torch.io.exec import TpuWriteFilesExec
    from spark_rapids_tpu_torch.io.parquet import ParquetWriterOptions
    from spark_rapids_tpu_torch.shims import current_shims
    node = meta.node
    if node.file_format == "parquet":
        # the session's rebase mode is frozen into the writer options, so
        # execution does not depend on the conf active when it runs
        opts = node.options or ParquetWriterOptions()
        if opts.rebase_mode is None:
            node = copy.copy(node)
            node.options = dataclasses.replace(
                opts, rebase_mode=current_shims(
                    meta.conf).parquet_rebase_write_mode(meta.conf))
    return TpuWriteFilesExec(node, kids[0])


def _register_io_rules() -> None:
    from spark_rapids_tpu_torch.io.exec import CpuFileScan, CpuWriteFiles
    register_exec(CpuFileScan, "columnar file scan", _conv_file_scan,
                  tag_extra=_tag_file_scan)
    register_exec(CpuWriteFiles, "columnar file write", _conv_write_files,
                  tag_extra=_tag_write_files)


_register_io_rules()


# --- pandas UDF execs (pyudf/exec.py) --------------------------------------
def _tag_pandas_exec(meta) -> None:
    # off by default (reference GpuOverrides.scala:1821-1845): the exec's
    # own enable key must be set
    name = meta.node.name()
    if not meta.conf.is_op_enabled("exec", name, default=False):
        meta.will_not_work_on_gpu(
            f"{name} is disabled by default; enable with "
            f"{C.op_enable_key('exec', name)}")


def _udf_args(n) -> list:
    return [a for u in n.udfs for a in u.args]


def _register_pyudf_rules() -> None:
    from spark_rapids_tpu_torch.pyudf import exec as PX
    for cpu, desc, conv, exprs_of in (
            (PX.CpuArrowEvalPython, "vectorized python UDF evaluation",
             lambda meta, kids: PX.ArrowEvalPythonExec(meta.node.udfs,
                                                       kids[0]),
             _udf_args),
            (PX.CpuMapInPandas, "mapInPandas",
             lambda meta, kids: PX.MapInPandasExec(meta.node, kids[0]),
             lambda n: ()),
            (PX.CpuFlatMapGroupsInPandas, "grouped applyInPandas",
             lambda meta, kids: PX.FlatMapGroupsInPandasExec(meta.node,
                                                             kids[0]),
             lambda n: ()),
            (PX.CpuAggregateInPandas, "grouped aggregate pandas UDF",
             lambda meta, kids: PX.AggregateInPandasExec(meta.node,
                                                         kids[0]),
             _udf_args),
            (PX.CpuWindowInPandas, "window pandas UDF",
             lambda meta, kids: PX.WindowInPandasExec(meta.node, kids[0]),
             _udf_args),
            (PX.CpuFlatMapCoGroupsInPandas, "cogrouped applyInPandas",
             lambda meta, kids: PX.FlatMapCoGroupsInPandasExec(
                 meta.node, kids[0], kids[1]),
             lambda n: ())):
        register_exec(cpu, desc, conv, exprs_of=exprs_of,
                      tag_extra=_tag_pandas_exec)


_register_pyudf_rules()


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
    if conf[C.UDF_COMPILER_ENABLED]:
        from spark_rapids_tpu_torch.udf import rewrite_udfs
        cpu_plan = rewrite_udfs(cpu_plan)
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
    plan._session_device = dev
    plan._meta = meta
    ExecutionPlanCapture.capture(plan)
    return plan


def collect(plan, conf: Optional[C.RapidsConf] = None):
    """Run an accelerated (or partly accelerated) plan to a pandas
    DataFrame under its session conf.  With spark.sql.adaptive.enabled,
    a fully accelerated plan runs stage at a time with runtime re-planning
    (plan/aqe.py).

    The serving layer's duties live here: the plan-fingerprint RESULT
    CACHE (a hit returns the cached frame bit-exactly without touching
    the device) and one QueryContext around the whole drive (deopt
    retries, the AQE stage loop, partly accelerated plans) carrying the
    conf snapshot, the CancelToken and the admission slot
    (exec/scheduler.py)."""
    from spark_rapids_tpu_torch.exec import scheduler as S
    conf = conf or getattr(plan, "_session_conf", None) or \
        C.get_active_conf()
    with C.session(conf):
        cache_key = S.result_cache_key(plan, conf)
        if cache_key is not None:
            hit = S.result_cache().get(cache_key)
            if hit is not None:
                return hit
        out = _collect(plan, conf)
        if cache_key is not None and hasattr(out, "memory_usage"):
            S.result_cache().put(cache_key, out,
                                 int(conf[C.RESULT_CACHE_MAX_BYTES]))
        return out


def _plan_device(plan):
    """Where the plan's device work runs: the device accelerate() was
    given, else a device plan's own."""
    dev = getattr(plan, "_session_device", None)
    if dev is None and isinstance(plan, TpuExec):
        dev = plan.device()
    return dev


def _collect(plan, conf: C.RapidsConf):
    """The deopt-and-retry boundary of PARTLY accelerated plans: a
    device->CPU transition inside the plan may raise FastPathInvalid
    from a deferred fast-path check; the fast paths at fault are
    disabled and the (pure) plan runs once more with every fast path
    off.  A fully accelerated plan retries inside TpuExec.collect."""
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.utils import checks as CK
    scope = S.QueryScope(conf, device=_plan_device(plan))
    error: Optional[BaseException] = None
    try:
        mark = CK.snapshot()
        try:
            return _collect_inner(plan, conf)
        except CK.FastPathInvalid as e:
            e.recover_all()
            CK.drain_since(mark)
            CK.set_retrying(True)
            try:
                return _collect_inner(plan, conf)
            finally:
                CK.set_retrying(False)
    except BaseException as e:
        error = e
        raise
    finally:
        scope.close(error=error)
        # no cycle through this frame (TpuExec.collect says why)
        error = None


def _collect_inner(plan, conf: C.RapidsConf):
    if isinstance(plan, TpuExec):
        from spark_rapids_tpu_torch.plan.transitions import df_from_batch
        if conf[C.ADAPTIVE_ENABLED]:
            from spark_rapids_tpu_torch.plan.aqe import (
                adaptive_execute, release_stage_buffers)
            adapted = adaptive_execute(plan, conf)
            if adapted is not plan:
                # the capture holds plans weakly: the final plan lives as
                # long as the plan the caller holds
                plan._aqe_final_plan = adapted
            ExecutionPlanCapture.capture(adapted)
            try:
                return df_from_batch(adapted.collect())
            finally:
                # the final plan must not pin the query's shuffle output
                # in device memory
                release_stage_buffers(adapted)
        return df_from_batch(plan.collect())
    from spark_rapids_tpu_torch.exec.base import new_execution
    new_execution()
    return plan.collect()


# ---------------------------------------------------------------------------
class _Capture(type):
    @property
    def last_plan(cls):
        """The plan the latest accelerate() returned, while something
        else holds it (None once it is dropped)."""
        return None if cls._last is None else cls._last()


class ExecutionPlanCapture(metaclass=_Capture):
    """The most recent accelerated plan, so tests can assert its shape
    and fallbacks.  It holds the plan weakly: a dropped plan frees its
    device batches at once."""

    _last: Optional[weakref.ref] = None

    @classmethod
    def capture(cls, plan) -> None:
        cls._last = weakref.ref(plan)

    @classmethod
    def assert_did_fall_back(cls, op_name: str) -> None:
        plan = cls.last_plan
        if plan is None:
            raise AssertionError("no plan captured")
        if not _find_cpu_node(plan, op_name):
            raise AssertionError(
                f"expected {op_name} to fall back to the CPU:\n{plan}")


def _children_through_transitions(plan) -> list:
    from spark_rapids_tpu_torch.plan.transitions import (ColumnarToRowExec,
                                                         RowToColumnarExec)
    if isinstance(plan, RowToColumnarExec):
        return [plan.cpu_child]
    if isinstance(plan, ColumnarToRowExec):
        return [plan.tpu_child]
    return list(plan.children)


def _find_cpu_node(plan, name: str) -> bool:
    if not isinstance(plan, TpuExec) and plan.name() == name:
        return True
    return any(_find_cpu_node(c, name)
               for c in _children_through_transitions(plan))
