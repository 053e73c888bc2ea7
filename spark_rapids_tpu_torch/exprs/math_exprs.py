"""Math expressions (port of spark_rapids_tpu/exprs/math_exprs.py).

Every unary transcendental gives a DOUBLE, as in Spark.  Their last bit
may differ from the JVM's, so the planner marks them incompatible
(spark.rapids.sql.incompatibleOps.enabled), as the reference does.  As
in the reference, the log of a value <= 0 is -Infinity or NaN, and Pow
and Atan2 keep their inputs' nulls alone.  Round is HALF_UP.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (BinaryExpression, Expression,
                                               UnaryExpression, true_divide)
from spark_rapids_tpu_torch.exprs.cast import f64_to_i64


@dataclasses.dataclass(eq=False, repr=False)
class _UnaryMath(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.FLOAT64

    def do_columnar(self, c, ctx):
        return ColumnVector(T.FLOAT64, self.op(c.data.to(torch.float64)),
                            c.validity)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root (torch has none): |x|^(1/3) with the sign, then one
    Newton step, which takes pow's error from the inexact 1/3 away.  A
    value below 2^-900 is scaled by 2^300 first (cbrt by 2^100), so the
    step never works in subnormals."""
    tiny = torch.abs(x) < 2.0 ** -900
    xs = torch.where(tiny, x * 2.0 ** 300, x)
    y = torch.sign(xs) * torch.pow(torch.abs(xs), 1.0 / 3.0)
    step = (y * y * y - xs) / (3.0 * y * y)
    y = torch.where(torch.isfinite(y) & (y != 0), y - step, y)
    return torch.where(tiny, y * 2.0 ** -100, y)


class Sqrt(_UnaryMath):
    def op(self, x): return torch.sqrt(x)


class Cbrt(_UnaryMath):
    def op(self, x): return _cbrt(x)


class Exp(_UnaryMath):
    def op(self, x): return torch.exp(x)


class Expm1(_UnaryMath):
    def op(self, x): return torch.expm1(x)


class Log(_UnaryMath):
    def op(self, x): return torch.log(x)


class Log1p(_UnaryMath):
    def op(self, x): return torch.log1p(x)


class Log2(_UnaryMath):
    def op(self, x): return torch.log2(x)


class Log10(_UnaryMath):
    def op(self, x): return torch.log10(x)


class Sin(_UnaryMath):
    def op(self, x): return torch.sin(x)


class Cos(_UnaryMath):
    def op(self, x): return torch.cos(x)


class Tan(_UnaryMath):
    def op(self, x): return torch.tan(x)


class Asin(_UnaryMath):
    def op(self, x): return torch.asin(x)


class Acos(_UnaryMath):
    def op(self, x): return torch.acos(x)


class Atan(_UnaryMath):
    def op(self, x): return torch.atan(x)


class Sinh(_UnaryMath):
    def op(self, x): return torch.sinh(x)


class Cosh(_UnaryMath):
    def op(self, x): return torch.cosh(x)


class Tanh(_UnaryMath):
    def op(self, x): return torch.tanh(x)


class ToDegrees(_UnaryMath):
    def op(self, x): return x * (180.0 / math.pi)


class ToRadians(_UnaryMath):
    def op(self, x): return x * (math.pi / 180.0)


class Rint(_UnaryMath):
    def op(self, x): return torch.round(x)  # half to even


class Signum(_UnaryMath):
    def op(self, x):
        # NaN and +-0 give themselves (torch.sign maps NaN to 0)
        return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x)).to(
            x.dtype)


class Cot(_UnaryMath):
    def op(self, x): return 1.0 / torch.tan(x)


class Acosh(_UnaryMath):
    def op(self, x): return torch.acosh(x)


class Asinh(_UnaryMath):
    def op(self, x): return torch.asinh(x)


class Atanh(_UnaryMath):
    def op(self, x): return torch.atanh(x)


@dataclasses.dataclass(eq=False, repr=False)
class Ceil(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.INT64

    def do_columnar(self, c, ctx):
        return ColumnVector(T.INT64, f64_to_i64(torch.ceil(
            c.data.to(torch.float64))), c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class Floor(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.INT64

    def do_columnar(self, c, ctx):
        return ColumnVector(T.INT64, f64_to_i64(torch.floor(
            c.data.to(torch.float64))), c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class _BinaryMath(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.FLOAT64

    def do_columnar(self, l, r, ctx):
        return ColumnVector(T.FLOAT64, self.op(l.data.to(torch.float64),
                                               r.data.to(torch.float64)),
                            l.validity & r.validity)


class Pow(_BinaryMath):
    def op(self, a, b): return torch.pow(a, b)


class Atan2(_BinaryMath):
    def op(self, a, b): return torch.atan2(a, b)


class Logarithm(_BinaryMath):
    """log(base, x) = ln(x) / ln(base)."""
    left: Expression   # base
    right: Expression  # value

    def op(self, base, val): return torch.log(val) / torch.log(base)


@dataclasses.dataclass(eq=False)
class Round(Expression):
    """round(x, scale), HALF_UP as Spark's round()."""
    child: Expression
    scale: int = 0

    def data_type(self, schema):
        return self.child.data_type(schema)

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Round(kids[0], self.scale)

    def eval(self, ctx):
        c = self.child.eval(ctx)
        if c.dtype.is_integral and self.scale >= 0:
            return c
        if c.dtype.is_integral:
            # a negative scale on integers: exact integer arithmetic (a
            # float64 round trip loses values past 2^53), and a
            # truncating division, as the reference's lax.div
            p = 10 ** (-self.scale)
            v = c.data.to(torch.int64)
            adj = torch.where(v >= 0, v + p // 2, v - p // 2)
            out = torch.div(adj, p, rounding_mode="trunc") * p
            return ColumnVector(c.dtype, out.to(c.data.dtype), c.validity)
        mul = 10.0 ** self.scale
        scaled = c.data.to(torch.float64) * mul
        # HALF_UP: a half rounds away from zero
        r = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                        torch.ceil(scaled - 0.5))
        return ColumnVector(c.dtype, true_divide(r, mul).to(c.data.dtype),
                            c.validity)
