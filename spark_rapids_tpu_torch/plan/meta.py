"""Meta-wrapper tree for plan tagging and conversion (port of
spark_rapids_tpu/plan/meta.py; the reference plugin's `RapidsMeta`):
per-node tag state with will-not-work reasons, the bottom-up tag pass,
conversion, and the explain text.

A CpuNode object that several parents share (TPC-H Q7 and Q8 join
`nation` twice) gets ONE meta: it is tagged and converted once, and its
exec is wrapped in `CommonSubplanExec`, so the subtree executes once
per query rather than once per consumer.
"""
from __future__ import annotations

import copy
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.plan.nodes import CpuNode


class BaseMeta:
    def __init__(self, conf: C.RapidsConf, parent: Optional["BaseMeta"]):
        self.conf = conf
        self.parent = parent
        self._reasons: set[str] = set()

    def will_not_work_on_gpu(self, reason: str) -> None:
        self._reasons.add(reason)

    @property
    def can_this_be_replaced(self) -> bool:
        return not self._reasons

    @property
    def reasons(self) -> set[str]:
        return self._reasons


class ExprMeta(BaseMeta):
    """Wraps one Expression node."""

    def __init__(self, expr: Expression, conf: C.RapidsConf,
                 parent: Optional[BaseMeta], rule):
        super().__init__(conf, parent)
        self.expr = expr
        self.rule = rule
        self.child_exprs = [wrap_expr(c, conf, self)
                            for c in expr.children()]

    def tag_for_gpu(self) -> None:
        for c in self.child_exprs:
            c.tag_for_gpu()
        name = type(self.expr).__name__
        if self.rule is None:
            self.will_not_work_on_gpu(
                f"expression {name} has no GPU implementation")
            return
        if not self.conf.is_op_enabled("expression", name):
            self.will_not_work_on_gpu(
                f"expression {name} disabled by "
                f"{C.op_enable_key('expression', name)}")

    @property
    def can_expr_tree_be_replaced(self) -> bool:
        return self.can_this_be_replaced and all(
            c.can_expr_tree_be_replaced for c in self.child_exprs)

    def all_reasons(self) -> set[str]:
        out = set(self._reasons)
        for c in self.child_exprs:
            out |= c.all_reasons()
        return out


class PlanMeta(BaseMeta):
    """Wraps one CpuNode; `device` is where its converted exec runs."""

    def __init__(self, node: CpuNode, conf: C.RapidsConf,
                 parent: Optional[BaseMeta], rule, device,
                 memo: Optional[dict] = None):
        super().__init__(conf, parent)
        self.node = node
        self.rule = rule
        self.device = device
        #: how many parents reach this node; above 1, conversion wraps
        #: the exec in CommonSubplanExec
        self.ref_count = 1
        self._tagged = False
        self.child_plans = [wrap_plan(c, conf, self, device, memo)
                            for c in node.children]
        exprs = rule.exprs_of(node) if rule is not None else []
        self.child_exprs = [wrap_expr(e, conf, self) for e in exprs]

    # -- tagging -------------------------------------------------------------
    def tag_for_gpu(self) -> None:
        # once per meta: a shared meta is reached from every parent
        if self._tagged:
            return
        self._tagged = True
        for c in self.child_plans:
            c.tag_for_gpu()
        for e in self.child_exprs:
            e.tag_for_gpu()
        name = self.node.name()
        if self.rule is None:
            self.will_not_work_on_gpu(f"exec {name} has no GPU "
                                      f"implementation")
            return
        if not self.conf.is_op_enabled("exec", name):
            self.will_not_work_on_gpu(
                f"exec {name} disabled by {C.op_enable_key('exec', name)}")
        bad = [e for e in self.child_exprs
               if not e.can_expr_tree_be_replaced]
        if bad:
            reasons: set = set()
            for e in bad:
                reasons |= e.all_reasons()
            self.will_not_work_on_gpu(
                "unsupported expressions: " + "; ".join(sorted(reasons)))
        self._tag_types()
        if self.rule.tag_extra is not None:
            self.rule.tag_extra(self)

    def _tag_types(self) -> None:
        """Type-matrix check."""
        try:
            schema = self.node.output_schema()
        except Exception as e:  # schema resolution failure -> CPU
            self.will_not_work_on_gpu(f"schema resolution failed: {e}")
            return
        for f in schema.fields:
            if f.dtype not in T.ALL_TYPES:
                self.will_not_work_on_gpu(
                    f"unsupported type {f.dtype} for column {f.name}")

    # -- conversion ----------------------------------------------------------
    def convert_if_needed(self, memo: Optional[dict] = None):
        """A TpuExec when this node goes on the GPU, else a copy of the
        CpuNode whose converted children are bridged by transitions.  A
        shared meta converts once and hands every parent the same
        CommonSubplanExec (`memo` maps id(meta) to its conversion for
        one pass; the metas keep none, so a plan is freed once dropped)."""
        if memo is None:
            memo = {}
        out = memo.get(id(self))
        if out is None:
            out = memo[id(self)] = self._convert_once(memo)
        return out

    def _convert_once(self, memo: dict):
        from spark_rapids_tpu_torch.exec.base import (CommonSubplanExec,
                                                      TpuExec)
        from spark_rapids_tpu_torch.plan.transitions import (
            ColumnarToRowExec, RowToColumnarExec)
        kids = [c.convert_if_needed(memo) for c in self.child_plans]
        if self.can_this_be_replaced:
            out = self.rule.convert(self, [
                k if isinstance(k, TpuExec)
                else RowToColumnarExec(k, self.device)
                for k in kids])
            if self.ref_count > 1:
                out = CommonSubplanExec(out)
            return out
        node = copy.copy(self.node)  # never mutate the caller's plan
        node.children = [k if isinstance(k, CpuNode)
                         else ColumnarToRowExec(k) for k in kids]
        return node

    # -- explain -------------------------------------------------------------
    def explain(self, all_nodes: bool = False, indent: int = 0,
                _seen: Optional[set] = None) -> str:
        if _seen is None:
            _seen = set()
        lines = []
        pad = "  " * indent
        reused = id(self) in _seen
        _seen.add(id(self))
        if self.can_this_be_replaced:
            if all_nodes:
                tag = " (reused subtree)" if reused else ""
                lines.append(f"{pad}*{self.node.name()} will run on "
                             f"GPU{tag}")
        else:
            why = "; ".join(sorted(self._reasons))
            lines.append(f"{pad}!{self.node.name()} cannot run on GPU "
                         f"because {why}")
        if not reused:
            for c in self.child_plans:
                s = c.explain(all_nodes, indent + 1, _seen)
                if s:
                    lines.append(s)
        return "\n".join(lines)


def wrap_expr(expr: Expression, conf: C.RapidsConf,
              parent: Optional[BaseMeta]) -> ExprMeta:
    from spark_rapids_tpu_torch.plan.overrides import expr_rule_for
    return ExprMeta(expr, conf, parent, expr_rule_for(expr))


def wrap_plan(node: CpuNode, conf: C.RapidsConf,
              parent: Optional[BaseMeta] = None, device="cuda",
              memo: Optional[dict] = None) -> PlanMeta:
    """The meta tree of `node`; a node object reached twice gets the same
    meta, its ref_count raised (`memo` maps id(node) to its meta)."""
    from spark_rapids_tpu_torch.plan.overrides import exec_rule_for
    if memo is None:
        memo = {}
    hit = memo.get(id(node))
    if hit is not None:
        hit.ref_count += 1
        return hit
    m = PlanMeta(node, conf, parent, exec_rule_for(node), device, memo)
    memo[id(node)] = m
    return m
