"""Predicates and comparisons (port of spark_rapids_tpu/exprs/predicates.py).

Spark parity:
  - NaN is greater than every other value and NaN == NaN;
  - And/Or use Kleene three-valued logic (false AND null = false);
  - EqualNullSafe (<=>) treats two nulls as equal;
  - strings compare lexicographically over their UTF-8 bytes;
  - x IN (...) is null when x is null, or when nothing matches and the
    list holds a null.
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    align_char_caps)
from spark_rapids_tpu_torch.exprs.base import (BinaryExpression, Expression,
                                               UnaryExpression, promote)


def _string_cmp(l: ColumnVector, r: ColumnVector):
    """Lexicographic compare of byte-tensor strings: (lt, eq).  The first
    differing position decides; past its end a string reads -1, so a
    prefix sorts first."""
    a, b = align_char_caps(l, r)
    pos = torch.arange(a.char_cap, device=a.data.device)[None, :]
    av = torch.where(pos < a.lengths[:, None], a.data.to(torch.int32), -1)
    bv = torch.where(pos < b.lengths[:, None], b.data.to(torch.int32), -1)
    diff = av != bv
    any_diff = diff.any(dim=1)
    first = diff.to(torch.int32).argmax(dim=1, keepdim=True)
    lt = any_diff & (av.gather(1, first) < bv.gather(1, first))[:, 0]
    return lt, ~any_diff


def _compare(l: ColumnVector, r: ColumnVector):
    """Returns (lt, eq) with Spark NaN semantics for floats."""
    if l.dtype.is_string:
        return _string_cmp(l, r)
    dt = l.dtype if l.dtype == r.dtype else T.common_type(l.dtype, r.dtype)
    l, r = promote(l, dt), promote(r, dt)
    a, b = l.data, r.data
    if dt.is_floating:
        na, nb = torch.isnan(a), torch.isnan(b)
        eq = torch.where(na & nb, True, a == b)
        lt = torch.where(na, False, torch.where(nb, True, a < b))
        return lt, eq
    return a < b, a == b


@dataclasses.dataclass(eq=False, repr=False)
class _Comparison(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.BOOL

    def do_columnar(self, l, r, ctx):
        lt, eq = _compare(l, r)
        return ColumnVector(T.BOOL, self.pick(lt, eq),
                            l.validity & r.validity)


class EqualTo(_Comparison):
    def pick(self, lt, eq):
        return eq


class LessThan(_Comparison):
    def pick(self, lt, eq):
        return lt


class LessThanOrEqual(_Comparison):
    def pick(self, lt, eq):
        return lt | eq


class GreaterThan(_Comparison):
    def pick(self, lt, eq):
        return ~(lt | eq)


class GreaterThanOrEqual(_Comparison):
    def pick(self, lt, eq):
        return ~lt


def _truth(c: ColumnVector):
    """(known true, known false) of a boolean column."""
    d = c.data.to(torch.bool)
    return c.validity & d, c.validity & ~d


@dataclasses.dataclass(eq=False)
class And(Expression):
    """Kleene: F AND x = F even if x is null."""
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return And(*kids)

    def eval(self, ctx):
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        (lt, lf), (rt, rf) = _truth(l), _truth(r)
        return ColumnVector(T.BOOL, lt & rt,
                            lf | rf | (l.validity & r.validity))

    def __repr__(self):
        return f"And({self.left!r}, {self.right!r})"


@dataclasses.dataclass(eq=False)
class Or(Expression):
    """Kleene: T OR x = T even if x is null."""
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return Or(*kids)

    def eval(self, ctx):
        l, r = self.left.eval(ctx), self.right.eval(ctx)
        (lt, _), (rt, _) = _truth(l), _truth(r)
        return ColumnVector(T.BOOL, lt | rt,
                            lt | rt | (l.validity & r.validity))

    def __repr__(self):
        return f"Or({self.left!r}, {self.right!r})"


@dataclasses.dataclass(eq=False)
class Not(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.BOOL

    def do_columnar(self, c, ctx):
        return ColumnVector(T.BOOL, ~c.data.to(torch.bool), c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class EqualNullSafe(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.BOOL

    def do_columnar(self, l, r, ctx):
        _, eq = _compare(l, r)
        both_null = ~l.validity & ~r.validity
        one_null = l.validity != r.validity
        data = torch.where(both_null, True, torch.where(one_null, False, eq))
        return ColumnVector(T.BOOL, data, ctx.row_mask)


@dataclasses.dataclass(eq=False)
class IsNull(Expression):
    child: Expression

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return IsNull(kids[0])

    def eval(self, ctx):
        c = self.child.eval(ctx)
        return ColumnVector(T.BOOL, ~c.validity & ctx.row_mask, ctx.row_mask)


@dataclasses.dataclass(eq=False)
class IsNotNull(Expression):
    child: Expression

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return IsNotNull(kids[0])

    def eval(self, ctx):
        c = self.child.eval(ctx)
        return ColumnVector(T.BOOL, c.validity & ctx.row_mask, ctx.row_mask)


@dataclasses.dataclass(eq=False, repr=False)
class IsNaN(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.BOOL

    def do_columnar(self, c, ctx):
        # Spark's IsNaN is not nullable: a null input gives false
        return ColumnVector(T.BOOL, torch.isnan(c.data) & c.validity,
                            ctx.row_mask)


def _equals_string_literal(c: ColumnVector, raw: bytes) -> torch.Tensor:
    """Rows of a string column whose bytes and length equal `raw`."""
    n = len(raw)
    if n > c.char_cap:
        return torch.zeros(c.capacity, dtype=torch.bool,
                           device=c.data.device)
    hit = c.lengths == n
    if n:
        want = torch.tensor(list(raw), dtype=c.data.dtype,
                            device=c.data.device)
        hit = hit & (c.data[:, :n] == want).all(dim=1)
    return hit


@dataclasses.dataclass(eq=False)
class InSet(Expression):
    """value IN (literal set).  Numbers compare against the set as one
    broadcast compare; strings compare bytes and length against each
    literal."""
    child: Expression
    values: tuple

    def data_type(self, schema):
        return T.BOOL

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return InSet(kids[0], self.values)

    def eval(self, ctx):
        c = self.child.eval(ctx)
        has_null_in_list = any(v is None for v in self.values)
        vals = [v for v in self.values if v is not None]
        hit = torch.zeros(c.capacity, dtype=torch.bool, device=ctx.device)
        if c.dtype.is_string:
            for v in vals:
                hit = hit | _equals_string_literal(c, str(v).encode("utf-8"))
        elif vals:
            want = torch.tensor(vals, dtype=c.dtype.torch_dtype,
                                device=ctx.device)
            hit = (c.data[:, None] == want[None, :]).any(dim=1)
        validity = c.validity & ~(~hit & has_null_in_list)
        return ColumnVector(T.BOOL, hit, validity)

    def __repr__(self):
        return f"InSet({self.child!r}, {self.values!r})"


def In(child: Expression, values) -> InSet:
    return InSet(child, tuple(values))
