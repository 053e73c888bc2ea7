"""Predicates and comparisons (port of spark_rapids_tpu/exprs/predicates.py:
the comparisons, Kleene And/Or and Not that TPC-H Q1 and Q6 use).

Spark parity:
  - NaN is greater than every other value and NaN == NaN;
  - And/Or use Kleene three-valued logic (false AND null = false);
  - strings compare lexicographically over their UTF-8 bytes.
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
