"""Expression simplification for fused stages (port of the parts of
spark_rapids_tpu/exprs/simplify.py that plan/fusion.py calls).

* `simplify`: bottom-up peephole rewrites of one tree: boolean-literal
  folds (`And(x, false)` is false under Kleene logic even when x is
  null), double negation, and literal integer comparison folding.
  Fusion runs it over a stage's COMPOSED expressions, so a constant
  introduced at one operator and consumed at another folds away.
* `dedup_common_subexprs`: across a list of bound trees (a fused stage's
  predicates and outputs), every non-trivial subtree that appears more
  than once is wrapped in a `SharedExpr` slot that evaluates once per
  batch.
* `is_identity_projection`: a projection that passes its input through
  unchanged, which fusion drops.
"""
from __future__ import annotations

import dataclasses
import operator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs.base import (
    Alias, BoundReference, Expression, Literal, fingerprint)


def _int_literal(e):
    if isinstance(e, Literal) and isinstance(e.value, int) \
            and not isinstance(e.value, bool):
        return e.value
    return None


def _bool_literal(e):
    if isinstance(e, Literal) and e.dtype == T.BOOL \
            and isinstance(e.value, bool):
        return e.value
    return None


_CMP_OPS = {P.GreaterThan: operator.gt, P.GreaterThanOrEqual: operator.ge,
            P.LessThan: operator.lt, P.LessThanOrEqual: operator.le,
            P.EqualTo: operator.eq}


def _simplify_one(e: Expression) -> Expression:
    cls = type(e)
    if cls is P.Not:
        if isinstance(e.child, P.Not):
            return e.child.child
        b = _bool_literal(e.child)
        if b is not None:
            return Literal(not b, T.BOOL)
    if cls in (P.And, P.Or):
        absorbing = cls is P.Or  # Or(x, true)=true; And(x, false)=false
        for lit_side, other in ((e.left, e.right), (e.right, e.left)):
            b = _bool_literal(lit_side)
            if b is None:
                continue
            # the absorbing element holds under Kleene logic even when
            # the other side is null
            return lit_side if b == absorbing else other
    if cls in _CMP_OPS:
        lk, rk = _int_literal(e.left), _int_literal(e.right)
        if lk is not None and rk is not None:
            return Literal(bool(_CMP_OPS[cls](lk, rk)), T.BOOL)
    return e


def simplify(e: Expression) -> Expression:
    """Bottom-up peephole pass; returns `e` itself when nothing
    changes."""
    return _simplify_one(e.map_children(simplify))


@dataclasses.dataclass(eq=False)
class SharedExpr(Expression):
    """Common-subexpression slot: evaluates its child ONCE per batch
    (memoized in `EvalContext.shared` by slot id); every other
    occurrence reads the value back.  Slots are numbered in
    first-appearance order."""
    child: Expression
    slot: int

    def data_type(self, schema):
        return self.child.data_type(schema)

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return SharedExpr(kids[0], self.slot)

    def eval(self, ctx):
        v = ctx.shared.get(self.slot)
        if v is None:
            v = ctx.shared[self.slot] = self.child.eval(ctx)
        return v

    def __repr__(self):
        return f"shared#{self.slot}({self.child!r})"


def _cse_trivial(e: Expression) -> bool:
    # leaves cost nothing to re-evaluate; sharing them is pure overhead
    return isinstance(e, (Literal, BoundReference)) or not e.children()


def dedup_common_subexprs(exprs: list) -> list:
    """Wrap every non-trivial subtree whose fingerprint appears more than
    once (within one tree or across trees) in a `SharedExpr` slot.  Top
    down, so the HIGHEST duplicated subtree gets the slot."""
    counts: dict = {}

    def scan(e: Expression) -> None:
        if not _cse_trivial(e):
            fp = fingerprint(e)
            counts[fp] = counts.get(fp, 0) + 1
        for c in e.children():
            scan(c)

    for e in exprs:
        scan(e)
    slots: dict = {}

    def rewrite(e: Expression) -> Expression:
        if not _cse_trivial(e):
            fp = fingerprint(e)
            if counts.get(fp, 0) > 1:
                slot = slots.setdefault(fp, len(slots))
                return SharedExpr(e.map_children(rewrite), slot)
        return e.map_children(rewrite)

    return [rewrite(e) for e in exprs]


def is_identity_projection(bound_exprs, in_schema, out_schema) -> bool:
    """True when output i is input column i (through any Alias chain)
    with the same name and dtype, for every column."""
    if len(bound_exprs) != len(in_schema.fields) or \
            len(out_schema.fields) != len(in_schema.fields):
        return False
    for i, (e, fi, fo) in enumerate(zip(bound_exprs, in_schema.fields,
                                        out_schema.fields)):
        while isinstance(e, Alias):
            e = e.child
        if not (isinstance(e, BoundReference) and e.ordinal == i):
            return False
        if fi.name != fo.name or fi.dtype != fo.dtype:
            return False
    return True
