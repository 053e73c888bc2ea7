"""Conditional and null-handling expressions (port of
spark_rapids_tpu/exprs/conditional.py).

Every branch is evaluated over the whole batch and the result picked
row by row with `torch.where`; string branches are padded to one char
capacity first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    align_char_caps)
from spark_rapids_tpu_torch.exprs.base import (EvalContext, Expression,
                                               Literal, promote)


def _select(cond: torch.Tensor, a: ColumnVector, b: ColumnVector
            ) -> ColumnVector:
    """where(cond, a, b) over ColumnVectors, string-aware."""
    if a.dtype.is_string:
        a, b = align_char_caps(a, b)
        data = torch.where(cond[:, None], a.data, b.data)
        lengths = torch.where(cond, a.lengths, b.lengths)
        validity = torch.where(cond, a.validity, b.validity)
        return ColumnVector(a.dtype, data, validity, lengths=lengths)
    dt = a.dtype if a.dtype == b.dtype else T.common_type(a.dtype, b.dtype)
    a, b = promote(a, dt), promote(b, dt)
    data = torch.where(cond, a.data, b.data)
    validity = torch.where(cond, a.validity, b.validity)
    return ColumnVector(dt, data, validity)


def _branch_type(schema, *exprs) -> T.DataType:
    """The branches' common type: what `_select` gives at eval time."""
    out = exprs[0].data_type(schema)
    for e in exprs[1:]:
        dt = e.data_type(schema)
        if dt != out:
            out = T.common_type(out, dt)
    return out


def _holds(c: ColumnVector) -> torch.Tensor:
    """True where a predicate is true; a null predicate is not."""
    return c.validity & c.data.to(torch.bool)


@dataclasses.dataclass(eq=False)
class If(Expression):
    predicate: Expression
    true_value: Expression
    false_value: Expression

    def data_type(self, schema):
        return _branch_type(schema, self.true_value, self.false_value)

    def children(self):
        return (self.predicate, self.true_value, self.false_value)

    def with_children(self, kids):
        return If(*kids)

    def eval(self, ctx: EvalContext):
        p = self.predicate.eval(ctx)
        t = self.true_value.eval(ctx)
        f = self.false_value.eval(ctx)
        return _select(_holds(p), t, f)


@dataclasses.dataclass(eq=False)
class CaseWhen(Expression):
    branches: tuple  # ((cond, value), ...)
    else_value: Optional[Expression] = None

    def data_type(self, schema):
        vals = [v for _, v in self.branches]
        if self.else_value is not None:
            vals.append(self.else_value)
        return _branch_type(schema, *vals)

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.else_value is not None:
            out.append(self.else_value)
        return tuple(out)

    def with_children(self, kids):
        n = len(self.branches)
        branches = tuple((kids[2 * i], kids[2 * i + 1]) for i in range(n))
        else_v = kids[2 * n] if len(kids) > 2 * n else None
        return CaseWhen(branches, else_v)

    def eval(self, ctx: EvalContext):
        dt = None
        evaluated = []
        for cond, val in self.branches:
            c = cond.eval(ctx)
            v = val.eval(ctx)
            dt = v.dtype if dt is None else dt
            evaluated.append((_holds(c), v))
        if self.else_value is not None:
            out = self.else_value.eval(ctx)
        else:  # no else: a null of the first branch's type
            out = Literal(None, dt).eval(ctx)
        for cond, v in reversed(evaluated):
            out = _select(cond, v, out)
        return out


@dataclasses.dataclass(eq=False)
class Coalesce(Expression):
    exprs: tuple

    def data_type(self, schema):
        return _branch_type(schema, *self.exprs)

    def children(self):
        return self.exprs

    def with_children(self, kids):
        return Coalesce(tuple(kids))

    def eval(self, ctx: EvalContext):
        out = self.exprs[0].eval(ctx)
        for e in self.exprs[1:]:
            v = e.eval(ctx)
            out = _select(out.validity, out, v)
        return out


def Nvl(a: Expression, b: Expression) -> Coalesce:
    return Coalesce((a, b))


@dataclasses.dataclass(eq=False)
class NullIf(Expression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return self.left.data_type(schema)

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return NullIf(*kids)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.exprs.predicates import EqualTo
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        eq = EqualTo(self.left, self.right).do_columnar(l, r, ctx)
        validity = l.validity & ~(eq.validity & eq.data)
        return ColumnVector(l.dtype, l.data, validity, lengths=l.lengths)


@dataclasses.dataclass(eq=False)
class Nvl2(Expression):
    expr: Expression
    not_null_val: Expression
    null_val: Expression

    def data_type(self, schema):
        return self.not_null_val.data_type(schema)

    def children(self):
        return (self.expr, self.not_null_val, self.null_val)

    def with_children(self, kids):
        return Nvl2(*kids)

    def eval(self, ctx):
        e = self.expr.eval(ctx)
        a = self.not_null_val.eval(ctx)
        b = self.null_val.eval(ctx)
        return _select(e.validity, a, b)


@dataclasses.dataclass(eq=False)
class AtLeastNNonNulls(Expression):
    """True when at least n of the children are non-null and non-NaN."""
    n: int
    exprs: tuple

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return self.exprs

    def with_children(self, kids):
        return AtLeastNNonNulls(self.n, tuple(kids))

    def eval(self, ctx: EvalContext):
        count = torch.zeros(ctx.capacity, dtype=torch.int32,
                            device=ctx.device)
        for e in self.exprs:
            v = e.eval(ctx)
            ok = v.validity
            if v.dtype.is_floating:
                ok = ok & ~torch.isnan(v.data)
            count = count + ok.to(torch.int32)
        return ColumnVector(T.BOOL, count >= self.n, ctx.row_mask)


@dataclasses.dataclass(eq=False)
class NaNvl(Expression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return self.left.data_type(schema)

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return NaNvl(*kids)

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        return _select(~torch.isnan(l.data), l, r)
