"""Comparisons (port of spark_rapids_tpu/exprs/predicates.py: the
LessThanOrEqual that Q1's filter uses, numeric operands only).

Spark parity: NaN is greater than every other value and NaN == NaN.
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (BinaryExpression, Expression,
                                               promote)


def _compare(l: ColumnVector, r: ColumnVector):
    """Returns (lt, eq) with Spark NaN semantics for floats."""
    dt = l.dtype if l.dtype == r.dtype else T.common_type(l.dtype, r.dtype)
    l, r = promote(l, dt), promote(r, dt)
    a, b = l.data, r.data
    if dt.is_floating:
        na, nb = torch.isnan(a), torch.isnan(b)
        eq = torch.where(na & nb, True, a == b)
        lt = torch.where(na, False, torch.where(nb, True, a < b))
        return lt, eq
    return a < b, a == b


@dataclasses.dataclass(eq=False)
class _Comparison(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.BOOL

    def do_columnar(self, l, r, ctx):
        lt, eq = _compare(l, r)
        return ColumnVector(T.BOOL, self.pick(lt, eq),
                            l.validity & r.validity)


class LessThanOrEqual(_Comparison):
    def pick(self, lt, eq):
        return lt | eq
