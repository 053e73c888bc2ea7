"""Whole-stage fusion of Project/Filter chains (port of
spark_rapids_tpu/plan/fusion.py).

The pass walks the physical plan between pipeline breaks (exchange,
coalesce, sort, the aggregate and the join's two sides are never
crossed; only Project and Filter are fusible) and collapses:

* `project -> filter -> project` chains (any mix, length >= 2) into a
  `FusedStageExec` that evaluates the whole stage straight off its input
  columns: each operator's bound references are inlined into its
  producer's expressions, so no intermediate batch is built;
* a Project/Filter chain that feeds a partial or complete aggregation
  into the aggregate itself, as its `pre_stage`, whose composed
  predicates and outputs every update lane evaluates before grouping.

A member with an ANSI-checked expression is never fused: it stays a
per-operator exec between the fused runs around it (the reference's
per-stage deopt).

Before evaluating, the composed DAG is simplified (`exprs/simplify.py`:
literal folding, then common-subexpression dedup, so a subtree shared
by several outputs evaluates once per batch).  PyTorch runs eagerly, so
the reference's compile cache and its trace-failure deopt lane have no
counterpart here.  Gate: spark.rapids.sql.fusion.enabled (default on).

SPMD mode (spark.rapids.sql.spmd.enabled, exec/spmd.py): the pass plans
for whole-mesh execution instead.  Fusible chains stay standalone
`FusedStageExec` nodes, a lone operator included (one gang dispatch
replaces one dispatch per partition), rather than folding into the
aggregate's update lane, so the gang sees them.  At execution time
`FusedStageExec.execute_partitions` hands the stage to the SPMD lane
while a mesh is active; otherwise (no mesh, a gang that cannot run) the
per-partition lane below runs.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.aggregate import AggMode, HashAggregateExec
from spark_rapids_tpu_torch.exec.base import (TpuExec, UnaryExecBase,
                                              make_eval_context)
from spark_rapids_tpu_torch.exec.basic import (FilterExec, ProjectExec,
                                               _register_ansi)
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.exprs.base import (BoundReference, EvalContext,
                                               Expression)
from spark_rapids_tpu_torch.exprs.simplify import (dedup_common_subexprs,
                                                   is_identity_projection,
                                                   simplify)

#: execs whose batch functions are pure expression evaluation: the only
#: members a fused stage may contain.  Everything else (exchange,
#: coalesce, sort, join) is a pipeline break.
_FUSIBLE = (ProjectExec, FilterExec)


def _contains_ansi(e: Expression) -> bool:
    """An ANSI-checked expression registers deferred error checks whose
    row scope would change under composition across a filter: the one
    expression the fuser refuses."""
    if getattr(e, "ansi", False):
        return True
    return any(_contains_ansi(c) for c in e.children())


def _member_fusible(ex: TpuExec) -> bool:
    bound = ex._bound if isinstance(ex, ProjectExec) else [ex._bound]
    return not any(_contains_ansi(e) for e in bound)


def inline_refs(e: Expression, producers: list) -> Expression:
    """Substitute every BoundReference with the producing operator's
    expression for that column."""
    if isinstance(e, BoundReference):
        return producers[e.ordinal]
    return e.map_children(lambda c: inline_refs(c, producers))


class ComposedStage:
    """The composed form of one fusion group: output expressions and
    filter predicates over the BASE child's schema, plus the original
    member execs (bottom-up)."""

    def __init__(self, out_exprs, preds, schema, in_schema, members):
        self.out_exprs = list(out_exprs)
        self.preds = list(preds)
        self.schema = schema
        self.in_schema = in_schema
        self.members = list(members)

    @property
    def expr_count(self) -> int:
        return len(self.out_exprs) + len(self.preds)

    def member_names(self) -> list:
        return [type(m).__name__ for m in self.members]

    def describe_ops(self) -> str:
        return "→".join(n.replace("Exec", "") for n in self.member_names())


def compose_chain(chain: list, in_schema: T.Schema) -> ComposedStage:
    """Compose a top-down Project/Filter chain into one ComposedStage
    over `in_schema`."""
    members = list(reversed(chain))  # bottom-up execution order
    producers: list = [BoundReference(i, f.dtype)
                       for i, f in enumerate(in_schema.fields)]
    preds: list = []
    for ex in members:
        if isinstance(ex, ProjectExec):
            producers = [inline_refs(b, producers) for b in ex._bound]
        else:
            preds.append(inline_refs(ex._bound, producers))
    outs = [simplify(e) for e in producers]
    preds = [simplify(p) for p in preds]
    deduped = dedup_common_subexprs(preds + outs)
    return ComposedStage(deduped[len(preds):], deduped[:len(preds)],
                         chain[0].output_schema(), in_schema, members)


def _eval_stage(stage: ComposedStage, ctx: EvalContext):
    """Evaluate the composed predicates (ANDed into the row mask) then
    the composed outputs under the final mask.  Returns (output
    columns, final mask)."""
    keep = ctx.row_mask
    for p in stage.preds:
        v = p.eval(ctx)
        keep = keep & v.validity & v.data.to(torch.bool)
    octx = EvalContext(ctx.columns, ctx.capacity, ctx.num_rows, keep,
                       ctx.pending_checks, ctx.shared)
    return [e.eval(octx) for e in stage.out_exprs], keep


def eval_stage_ctx(stage: ComposedStage, ctx: EvalContext) -> EvalContext:
    """The aggregate-update prologue: the consuming lane sees the
    post-stage columns and row mask."""
    cols, keep = _eval_stage(stage, ctx)
    return EvalContext(cols, ctx.capacity, ctx.num_rows, keep,
                       ctx.pending_checks, ctx.shared)


class FusedStageExec(UnaryExecBase):
    """A fused Project/Filter chain evaluated in one pass per batch.  With
    filter members the output is a sparse batch exactly like
    FilterExec's; a pure-project stage passes the input's row count and
    sparse mask through."""

    def __init__(self, stage: ComposedStage, child: TpuExec):
        super().__init__(child)
        self.stage = stage
        self._schema = stage.schema
        self._fused_reported = False
        #: set once the SPMD lane fell back for this exec (exec/spmd.py)
        self._spmd_deopt = False

    def output_schema(self) -> T.Schema:
        return self._schema

    @property
    def coalesce_after(self) -> bool:
        return bool(self.stage.preds)  # filters shrink batches

    def describe(self):
        return (f"FusedStageExec({self.stage.describe_ops()}, "
                f"exprs={self.stage.expr_count}"
                + (", spmd-deopt" if self._spmd_deopt else "") + ")")

    def execute_partitions(self):
        # the SPMD lane (exec/spmd.py): one gang dispatch for every
        # partition of this stage while the conf enables it and a mesh
        # is active; None = the per-partition lane
        from spark_rapids_tpu_torch.exec import spmd as SP
        lane = SP.maybe_execute_spmd(self)
        if lane is not None:
            return lane
        return super().execute_partitions()

    @property
    def fused_members(self) -> list:
        """(describe, MetricSet) per member: the EXPLAIN-with-metrics
        breakdown (utils/profile.py renders these under the node)."""
        return [(m.describe(), m.metrics) for m in self.stage.members]

    def _kp_members(self) -> list:
        return self.stage.member_names()

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for m in self.stage.members:
            s += "\n" + "  " * (indent + 1) + "* " + m.describe()
        for c in self._children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        for batch in batches:
            if not self._fused_reported:
                # the profiler's stage_fused event, once per exec
                self._fused_reported = True
                P.event(P.EV_STAGE_FUSED, members=self.stage.member_names(),
                        exprs=self.stage.expr_count)
            with self.kp_step("fused-stage", batch.capacity,
                              device=batch.device,
                              members=self.stage.member_names()) as kw:
                ctx = make_eval_context(batch.columns, batch.capacity,
                                        batch.num_rows_i32, batch.sparse)
                cols, keep = _eval_stage(self.stage, ctx)
                checks = batch.checks + _register_ansi(ctx)
                if kw.wants_cost():
                    kw.cost(batch, cols, keep)
            if self.stage.preds:
                yield ColumnarBatch(self._schema, cols,
                                    keep.sum().to(torch.int32), checks,
                                    sparse=keep)
            else:
                yield ColumnarBatch(self._schema, cols, batch._rows, checks,
                                    batch.sparse)


# ---------------------------------------------------------------------------
def fuse_plan(plan, conf: Optional[C.RapidsConf] = None):
    """Fuse every device subtree of `plan` (a TpuExec, or a CpuNode tree
    with device islands).  Identity when spark.rapids.sql.fusion.enabled
    is off."""
    conf = conf or C.get_active_conf()
    if not conf[C.FUSION_ENABLED]:
        return plan
    spmd = bool(conf[C.SPMD_ENABLED])
    if isinstance(plan, TpuExec):
        return _fuse_node(plan, spmd)
    _fuse_islands(plan, spmd)
    return plan


def _fuse_islands(node, spmd: bool = False) -> None:
    from spark_rapids_tpu_torch.plan.transitions import ColumnarToRowExec
    if isinstance(node, ColumnarToRowExec):
        node.tpu_child = _fuse_node(node.tpu_child, spmd)
        return
    for c in getattr(node, "children", []):
        _fuse_islands(c, spmd)


def _collect_chain(node: TpuExec):
    """Maximal Project/Filter chain from `node` down: (chain top-down,
    base child)."""
    chain: list = []
    cur = node
    while isinstance(cur, _FUSIBLE):
        chain.append(cur)
        cur = cur.child
    return chain, cur


def _agg_fusible(node: TpuExec) -> bool:
    return (isinstance(node, HashAggregateExec)
            and node.mode in (AggMode.PARTIAL, AggMode.COMPLETE)
            and node._pre_stage is None)


def _fuse_segment(run: list, base: TpuExec, spmd: bool = False) -> TpuExec:
    """One bottom-up run of fusible members over `base` as one fused
    stage; a lone operator stays as it is (SPMD mode fuses it too: the
    gang amortizes over partitions, not over chain length), and an
    identity projection disappears."""
    stage = compose_chain(list(reversed(run)), base.output_schema())
    if not stage.preds and is_identity_projection(
            stage.out_exprs, stage.in_schema, stage.schema):
        return base
    if len(run) < 2 and not spmd:
        run[0]._children[0] = base
        return run[0]
    return FusedStageExec(stage, base)


def _fuse_chain(chain: list, base: TpuExec, spmd: bool = False) -> TpuExec:
    """Rebuild a top-down Project/Filter chain over `base`, fusing each
    maximal run of fusible members; a member that is not fusible stays
    per-operator between them."""
    members = list(reversed(chain))  # bottom-up execution order
    cur, i = base, 0
    while i < len(members):
        j = i
        while j < len(members) and _member_fusible(members[j]):
            j += 1
        if j > i:
            cur = _fuse_segment(members[i:j], cur, spmd)
            i = j
        else:
            members[i]._children[0] = cur
            cur = members[i]
            i += 1
    return cur


def _fuse_node(node: TpuExec, spmd: bool = False) -> TpuExec:
    from spark_rapids_tpu_torch.plan.transitions import RowToColumnarExec
    if isinstance(node, RowToColumnarExec):
        _fuse_islands(node.cpu_child, spmd)
        return node
    if _agg_fusible(node) and not spmd:
        # in SPMD mode the chain stays a standalone stage below, which the
        # gang runs over the mesh, and the aggregate consumes its outputs
        chain, base = _collect_chain(node.child)
        if chain and all(_member_fusible(m) for m in chain):
            return HashAggregateExec(
                node.group_exprs, node.aggregates, _fuse_node(base),
                mode=node.mode,
                pre_stage=compose_chain(chain, base.output_schema()))
    if isinstance(node, _FUSIBLE):
        chain, base = _collect_chain(node)
        return _fuse_chain(chain, _fuse_node(base, spmd), spmd)
    for i, c in enumerate(node.children):
        node._children[i] = _fuse_node(c, spmd)
    return node
