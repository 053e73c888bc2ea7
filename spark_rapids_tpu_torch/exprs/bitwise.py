"""Bitwise expressions (port of spark_rapids_tpu/exprs/bitwise.py): and,
or, xor, not and the shifts.

As in Java and Spark, a shift distance is masked to the value's bit
width (x << 33 on an int is x << 1).  Torch's right shift of a signed
integer is arithmetic; the unsigned one is that shift with the bits
shifted in from the sign masked off.
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (BinaryExpression, Expression,
                                               UnaryExpression, promote)


@dataclasses.dataclass(eq=False, repr=False)
class _BitwiseBin(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.common_type(self.left.data_type(schema),
                             self.right.data_type(schema))

    def do_columnar(self, l, r, ctx):
        dt = T.common_type(l.dtype, r.dtype)
        l, r = promote(l, dt), promote(r, dt)
        return ColumnVector(dt, self.op(l.data, r.data),
                            l.validity & r.validity)


class BitwiseAnd(_BitwiseBin):
    def op(self, a, b): return a & b


class BitwiseOr(_BitwiseBin):
    def op(self, a, b): return a | b


class BitwiseXor(_BitwiseBin):
    def op(self, a, b): return a ^ b


@dataclasses.dataclass(eq=False, repr=False)
class BitwiseNot(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        return ColumnVector(c.dtype, ~c.data, c.validity)


def _bits(data: torch.Tensor) -> int:
    return data.element_size() * 8


def _mask_shift(data: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return (shift & (_bits(data) - 1)).to(data.dtype)


@dataclasses.dataclass(eq=False, repr=False)
class _Shift(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return self.left.data_type(schema)

    def do_columnar(self, l, r, ctx):
        return ColumnVector(l.dtype,
                            self.op(l.data, _mask_shift(l.data, r.data)),
                            l.validity & r.validity)


class ShiftLeft(_Shift):
    def op(self, a, s): return torch.bitwise_left_shift(a, s)


class ShiftRight(_Shift):
    def op(self, a, s): return torch.bitwise_right_shift(a, s)


class ShiftRightUnsigned(_Shift):
    def op(self, a, s):
        # the arithmetic shift, then the top s bits cleared: the mask
        # (1 << (bits - s)) - 1 wraps to all ones but the sign at s = 1;
        # a shift of 0 keeps every bit
        one = torch.ones_like(a)
        mask = torch.bitwise_left_shift(one, _bits(a) - s) - one
        return torch.where(s == 0, a, torch.bitwise_right_shift(a, s) & mask)
