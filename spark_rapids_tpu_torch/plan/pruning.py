"""Column pruning (port of spark_rapids_tpu/plan/pruning.py `prune_columns`
for the nodes the port has).

Top-down required-column analysis, bottom-up rebuild: source leaves
narrow to the columns referenced above them, so an in-memory source
uploads fewer columns and wide string columns never ride through
kernels they take no part in.  Conservative: a node type it does not
know keeps its subtree untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exprs.base import AttributeReference, Expression
from spark_rapids_tpu_torch.plan import nodes as N


def expr_refs(obj) -> set:
    """Column names referenced anywhere in an expression-bearing object
    (expressions, aggregate aliases, sort orders, nested sequences)."""
    out: set = set()

    def walk(v):
        if v is None:
            return
        if isinstance(v, AttributeReference):
            out.add(v.name)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, Expression):
            for c in v.children():
                walk(c)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
    walk(obj)
    return out


def prune_columns(node: N.CpuNode, required: Optional[set] = None
                  ) -> N.CpuNode:
    """An equivalent tree whose leaves produce only `required` columns
    (None = all).  Never mutates the input."""
    if isinstance(node, N.CpuSource):
        schema = node.output_schema()
        if required is None or required >= set(schema.names):
            return node
        keep = [f.name for f in schema.fields if f.name in required]
        if not keep:  # count(*)-style: keep one column for the rows
            keep = [schema.fields[0].name]
        return N.CpuSource([p[keep] for p in node.partitions],
                           T.Schema(tuple(schema.field(k) for k in keep)))
    if isinstance(node, N.CpuProject):
        return N.CpuProject(node.exprs, prune_columns(
            node.child, expr_refs(node.exprs)))
    if isinstance(node, N.CpuFilter):
        need = None if required is None else \
            required | expr_refs(node.condition)
        return N.CpuFilter(node.condition, prune_columns(node.child, need))
    if isinstance(node, N.CpuAggregate):
        need = expr_refs(node.group_exprs) | expr_refs(node.aggregates)
        return N.CpuAggregate(node.group_exprs, node.aggregates,
                              prune_columns(node.child, need))
    if isinstance(node, N.CpuSort):
        need = None if required is None else \
            required | expr_refs(node.order)
        return N.CpuSort(node.order, prune_columns(node.child, need),
                         node.global_sort)
    if isinstance(node, N.CpuLimit):
        return N.CpuLimit(node.n, prune_columns(node.child, required),
                          node.global_limit)
    if isinstance(node, N.CpuHashJoin):
        lnames = set(node.children[0].output_schema().names)
        rnames = set(node.children[1].output_schema().names)
        cond = expr_refs(node.condition)
        if required is None:
            lreq = rreq = None
        else:
            above = set(required) | cond
            lreq = (above & lnames) | expr_refs(node.left_keys)
            rreq = (above & rnames) | expr_refs(node.right_keys)
        if node.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            # the right side exists only for the match: keys + condition
            rreq = expr_refs(node.right_keys) | (cond & rnames)
        return N.CpuHashJoin(node.join_type, node.left_keys,
                             node.right_keys,
                             prune_columns(node.children[0], lreq),
                             prune_columns(node.children[1], rreq),
                             condition=node.condition,
                             broadcast=node.broadcast)
    return node  # unknown node: keep its subtree
