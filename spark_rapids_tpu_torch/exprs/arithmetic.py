"""Arithmetic expressions (port of spark_rapids_tpu/exprs/arithmetic.py:
Add, Subtract, Multiply).

Operands widen to Spark's common type first, so FLOAT * DOUBLE computes
in float64 and integer overflow wraps like Java's two's complement.
"""
from __future__ import annotations

import dataclasses

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (
    BinaryExpression, Expression, numeric_result_type, promote)


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
