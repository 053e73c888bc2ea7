"""Column pruning (port of spark_rapids_tpu/plan/pruning.py `prune_columns`
for the nodes the port has, file scans among them).

Top-down required-column analysis, bottom-up rebuild: source leaves
narrow to the columns referenced above them, so an in-memory source
uploads fewer columns and wide string columns never ride through
kernels they take no part in.  Conservative: a node type it does not
know keeps its subtree untouched.  A node object that several parents
share is pruned once, to the union of what its parents need, and stays
shared (the planner then executes it once: plan/meta.py).
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
    (None = all).  Never mutates the input.  DAG-aware: a shared node is
    pruned with the union of its parents' requirements and the same
    pruned object goes back to every parent."""
    # pass 1: reference counts over the DAG
    refs: dict = {}
    nodes_by_id: dict = {}

    def count(n):
        refs[id(n)] = refs.get(id(n), 0) + 1
        if refs[id(n)] == 1:
            nodes_by_id[id(n)] = n
            for c in n.children:
                count(c)
    count(node)
    shared = {i for i, c in refs.items() if c > 1}

    if not shared:
        def rec(c, r):
            return _pinned(c, _prune(c, r, rec))
        return _pinned(node, _prune(node, required, rec))

    # pass 2: a fixpoint of the requirement unions at shared nodes
    # (None = all columns, absorbing)
    req_u: dict = {}

    def merge(i, req):
        if i not in req_u:
            req_u[i] = None if req is None else set(req)
        elif req_u[i] is not None:
            req_u[i] = None if req is None else req_u[i] | req

    def analyze(child, req):
        if id(child) in shared:
            merge(id(child), req)
            return child  # analyzed from its own union below
        return _prune(child, req, analyze, build=False)

    def snapshot():
        return {i: (None if v is None else frozenset(v))
                for i, v in req_u.items()}

    _prune(node, required, analyze, build=False)
    for _ in range(len(shared) + 1):
        before = snapshot()
        for i in list(req_u):
            _prune(nodes_by_id[i], req_u[i], analyze, build=False)
        if snapshot() == before:
            break

    # pass 3: the memoized rebuild
    memo: dict = {}

    def build(child, req):
        i = id(child)
        if i in shared:
            if i not in memo:
                memo[i] = _pinned(child, _prune(child, req_u.get(i), build))
            return memo[i]
        return _pinned(child, _prune(child, req, build))

    return _pinned(node, _prune(node, required, build))


def _pinned(node: N.CpuNode, out: N.CpuNode) -> N.CpuNode:
    """Move a verdict AQE's query-stage prep pinned on `node`
    (`_tpu_tag`, plan/aqe.py) to its pruned copy, which is the node the
    planner tags; a pin is used once, so the original gives it up."""
    if out is not node and "_tpu_tag" in node.__dict__:
        out._tpu_tag = node.__dict__.pop("_tpu_tag")
    return out


def _prune(node: N.CpuNode, required: Optional[set], prune_columns,
           build: bool = True) -> N.CpuNode:
    """One pruning step; it recurses through the `prune_columns`
    callback, so the DAG-aware pass sees shared children.  With
    build=False it only analyzes: no source is narrowed."""
    if isinstance(node, N.CpuSource):
        schema = node.output_schema()
        if not build or required is None or required >= set(schema.names):
            return node
        keep = [f.name for f in schema.fields if f.name in required]
        if not keep:  # count(*)-style: keep one column for the rows
            keep = [schema.fields[0].name]
        pruned = N.CpuSource([p[keep] for p in node.partitions],
                             T.Schema(tuple(schema.field(k) for k in keep)))
        # the narrowed copies are made anew on every plan; the result
        # cache keys source identity on the session's own frames (the
        # kept columns follow from the plan's structure)
        pruned.source_identity = getattr(
            node, "source_identity", None) or tuple(node.partitions)
        return pruned
    if type(node).__name__ == "CpuFileScan":
        schema = node.output_schema()
        if not build or required is None \
                or required >= set(schema.names) \
                or node.scan.file_format == "csv":
            return node  # csv readers key off the full file column list
        keep = set(required) or {schema.fields[0].name}
        out = type(node)(node.scan.pruned(keep))
        out.pushed_filter = node.pushed_filter
        return out
    if isinstance(node, N.CpuProject):
        return N.CpuProject(node.exprs, prune_columns(
            node.child, expr_refs(node.exprs)))
    if isinstance(node, N.CpuFilter):
        need = None if required is None else \
            required | expr_refs(node.condition)
        return N.CpuFilter(node.condition, prune_columns(node.child, need))
    if isinstance(node, N.CpuAggregate):
        need = expr_refs(node.group_exprs) | expr_refs(node.aggregates)
        # type(node): a CpuSortAggregate stays one
        return type(node)(node.group_exprs, node.aggregates,
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
        # type(node): a CpuSortMergeJoin keeps its own rule
        return type(node)(node.join_type, node.left_keys, node.right_keys,
                          prune_columns(node.children[0], lreq),
                          prune_columns(node.children[1], rreq),
                          condition=node.condition,
                          broadcast=node.broadcast)
    if isinstance(node, N.CpuNestedLoopJoin):
        if required is None:
            lreq = rreq = None
        else:
            above = set(required) | expr_refs(node.condition)
            lreq = above & set(node.children[0].output_schema().names)
            rreq = above & set(node.children[1].output_schema().names)
        left = prune_columns(node.children[0], lreq)
        right = prune_columns(node.children[1], rreq)
        if isinstance(node, N.CpuCartesianProduct):
            return N.CpuCartesianProduct(left, right, node.condition)
        return N.CpuNestedLoopJoin(node.join_type, left, right,
                                   node.condition)
    if isinstance(node, N.CpuUnion):
        kids = [prune_columns(c, required) for c in node.children]
        if build:
            # union children line up by position; a shared child pruned
            # to the union of its parents' needs can come back wider
            # than its siblings: project it down to what this union asks
            schema0 = node.children[0].output_schema()
            want = [f.name for f in schema0.fields
                    if required is None or f.name in required]
            if not want:
                want = [schema0.fields[0].name]
            kids = [k if list(k.output_schema().names) == want
                    else N.CpuProject([AttributeReference(n) for n in want],
                                      k)
                    for k in kids]
        return N.CpuUnion(*kids)
    if isinstance(node, N.CpuShuffleExchange):
        need = None if required is None else \
            required | expr_refs(node.spec)
        return N.CpuShuffleExchange(node.spec,
                                    prune_columns(node.child, need))
    if isinstance(node, N.CpuExpand):
        return N.CpuExpand(node.projections, node.names, prune_columns(
            node.child, expr_refs(node.projections)))
    return node  # unknown node: keep its subtree
