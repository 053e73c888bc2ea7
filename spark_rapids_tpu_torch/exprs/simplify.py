"""Expression simplification for fused stages (port of the parts of
spark_rapids_tpu/exprs/simplify.py that plan/fusion.py calls).

* `simplify`: bottom-up peephole rewrites of one tree: boolean-literal
  folds (`And(x, false)` is false under Kleene logic even when x is
  null), double negation, literal integer comparison folding, the
  collapse of a double or identity cast (never an ANSI one), and a
  presence test on a find or locate position rewritten to Contains (or
  StartsWith), which needs the match matrix alone, not the character
  positions.  With F a 0-based find (-1 when absent, the UDF
  compiler's `Subtract(StringLocate(sub, s), 1)`) and L a 1-based
  locate (0 when absent), both over a literal with start 1:

    F >= 0, F > -1       ->  Contains(s, sub)
    F < 0, F <= -1, F == -1   ->  Not(Contains(s, sub))
    F == 0               ->  StartsWith(s, sub)
    L >= 1, L > 0        ->  Contains(s, sub)
    L < 1, L <= 0, L == 0     ->  Not(Contains(s, sub))
    L == 1               ->  StartsWith(s, sub)

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
from spark_rapids_tpu_torch.exprs import arithmetic as A
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs import string_fns as S
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


def _as_find(e):
    """(string, pattern, absent value) of F or L over a literal pattern
    with start 1, else None."""
    if isinstance(e, A.Subtract) and _int_literal(e.right) == 1 \
            and isinstance(e.left, S.StringLocate):
        loc, absent = e.left, -1
    elif isinstance(e, S.StringLocate):
        loc, absent = e, 0
    else:
        return None
    if not isinstance(loc.substr, Literal) or loc.substr.value is None:
        return None
    if loc.start is not None and _int_literal(loc.start) != 1:
        return None
    return loc.child, loc.substr, absent


_FLIP = {P.GreaterThan: P.LessThan, P.GreaterThanOrEqual: P.LessThanOrEqual,
         P.LessThan: P.GreaterThan, P.LessThanOrEqual: P.GreaterThanOrEqual,
         P.EqualTo: P.EqualTo}


def _simplify_cast(e: Expression) -> Expression:
    """cast(cast(x as t) as t) -> cast(x as t); a cast of a column to
    its own type -> the column.  An ANSI cast carries its overflow check
    and is kept."""
    from spark_rapids_tpu_torch.exprs.cast import Cast
    if e.ansi:
        return e
    c = e.child
    if isinstance(c, Cast) and not c.ansi and c.to == e.to:
        return Cast(c.child, e.to)
    if isinstance(c, BoundReference) and c.dtype == e.to:
        return c
    return e


def _simplify_find(e: Expression) -> Expression:
    """A comparison of a find or locate position with an integer
    literal that only tests presence (table in the module docstring)."""
    cls = type(e)
    lhs, rhs = e.left, e.right
    k = _int_literal(rhs)
    if k is None:
        # the literal on the left: flip into `position CMP k`
        k = _int_literal(lhs)
        if k is None:
            return e
        lhs, cls = rhs, _FLIP[cls]
    m = _as_find(lhs)
    if m is None:
        return e
    s, sub, absent = m
    contains = S.Contains(s, sub)
    # a position is >= absent + 1 when present, == absent when missing
    if cls in (P.GreaterThan, P.GreaterThanOrEqual):
        if (k if cls is P.GreaterThanOrEqual else k + 1) == absent + 1:
            return contains
    elif cls in (P.LessThan, P.LessThanOrEqual):
        if (k if cls is P.LessThanOrEqual else k - 1) == absent:
            return P.Not(contains)
    elif cls is P.EqualTo:
        if k == absent:
            return P.Not(contains)
        if k == absent + 1:
            return S.StartsWith(s, sub)
    return e


def _simplify_one(e: Expression) -> Expression:
    cls = type(e)
    if cls.__name__ == "Cast":
        return _simplify_cast(e)
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
        return _simplify_find(e)
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
