"""Arithmetic expressions (port of spark_rapids_tpu/exprs/arithmetic.py).

Operands widen to Spark's common type first, so FLOAT * DOUBLE computes
in float64 and integer overflow wraps like Java's two's complement.
Spark's non-ANSI rules:
  - `/` always yields DOUBLE, and x / 0 is null;
  - `div`, `%` and pmod by zero are null; `%` keeps the dividend's sign
    (Java), pmod is never negative for a positive divisor;
  - MIN / -1 is MIN and MIN % -1 is 0, as Java's long arithmetic gives
    them (the divisor becomes 1 there, so no division traps).
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Expression, UnaryExpression, numeric_result_type,
    promote)


@dataclasses.dataclass(eq=False, repr=False)
class _BinaryArith(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return numeric_result_type(schema, self.left, self.right)

    def do_columnar(self, l: ColumnVector, r: ColumnVector, ctx):
        dt = T.common_type(l.dtype, r.dtype)
        l, r = promote(l, dt), promote(r, dt)
        return ColumnVector(dt, self.op(l.data, r.data),
                            l.validity & r.validity)


class Add(_BinaryArith):
    def op(self, a, b):
        return a + b


class Subtract(_BinaryArith):
    def op(self, a, b):
        return a - b


class Multiply(_BinaryArith):
    def op(self, a, b):
        return a * b


@dataclasses.dataclass(eq=False, repr=False)
class Divide(BinaryExpression):
    """Double division; divide-by-zero -> null (Spark non-ANSI)."""
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.FLOAT64

    def do_columnar(self, l, r, ctx):
        a = l.data.to(torch.float64)
        b = r.data.to(torch.float64)
        zero = b == 0.0
        validity = l.validity & r.validity & ~zero
        data = a / torch.where(zero, 1.0, b)
        return ColumnVector(T.FLOAT64, data, validity)


def _safe_divisor(a: torch.Tensor, b: torch.Tensor, zero: torch.Tensor
                  ) -> torch.Tensor:
    """`b` with 1 where it is zero and, for integers, where a = MIN and
    b = -1 (the one quotient that overflows: 1 gives Java's MIN and 0)."""
    if b.dtype.is_floating_point:
        return torch.where(zero, 1.0, b)
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    return torch.where(zero | overflow, 1, b)


@dataclasses.dataclass(eq=False, repr=False)
class IntegralDivide(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.INT64

    def do_columnar(self, l, r, ctx):
        a = l.data.to(torch.int64)
        b = r.data.to(torch.int64)
        zero = b == 0
        validity = l.validity & r.validity & ~zero
        # truncates toward zero, as Java's / and Spark's div do
        q = torch.div(a, _safe_divisor(a, b, zero), rounding_mode="trunc")
        return ColumnVector(T.INT64, q, validity)


@dataclasses.dataclass(eq=False, repr=False)
class Remainder(BinaryExpression):
    """x % 0 -> null; the result's sign follows the dividend (Java %)."""
    left: Expression
    right: Expression

    def data_type(self, schema):
        return numeric_result_type(schema, self.left, self.right)

    def do_columnar(self, l, r, ctx):
        dt = T.common_type(l.dtype, r.dtype)
        l, r = promote(l, dt), promote(r, dt)
        zero = r.data == 0
        validity = l.validity & r.validity & ~zero
        data = torch.fmod(l.data, _safe_divisor(l.data, r.data, zero))
        return ColumnVector(dt, data, validity)


@dataclasses.dataclass(eq=False, repr=False)
class Pmod(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return numeric_result_type(schema, self.left, self.right)

    def do_columnar(self, l, r, ctx):
        dt = T.common_type(l.dtype, r.dtype)
        l, r = promote(l, dt), promote(r, dt)
        zero = r.data == 0
        safe = _safe_divisor(l.data, r.data, zero)
        rem = torch.fmod(l.data, safe)
        data = torch.where((rem != 0) & ((rem < 0) != (safe < 0)),
                           rem + safe, rem)
        validity = l.validity & r.validity & ~zero
        return ColumnVector(dt, data, validity)


@dataclasses.dataclass(eq=False, repr=False)
class UnaryMinus(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        return ColumnVector(c.dtype, -c.data, c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class UnaryPositive(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        return c


@dataclasses.dataclass(eq=False, repr=False)
class Abs(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        return ColumnVector(c.dtype, torch.abs(c.data), c.validity)
