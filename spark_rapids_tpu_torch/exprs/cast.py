"""Cast expression (port of spark_rapids_tpu/exprs/cast.py, its numeric,
boolean and date part).

Spark's non-ANSI semantics:
  - float -> integral: Java's, truncate toward zero, saturate at the
    type's bounds, NaN -> 0;
  - numeric -> bool: nonzero is true; bool -> numeric: 1 / 0;
  - integral and float widening or narrowing: wraps like Java.

Casts to and from strings, and ANSI casts, are not ported:
`Cast.supported` names the pairs this module evaluates, and the planner
leaves any other pair to the CPU (plan/overrides.py).
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import EvalContext, Expression

_INT_BOUNDS = {
    T.TypeId.INT32: (-(2 ** 31), 2 ** 31 - 1),
    T.TypeId.INT64: (-(2 ** 63), 2 ** 63 - 1),
}


@dataclasses.dataclass(eq=False)
class Cast(Expression):
    child: Expression
    to: T.DataType
    ansi: bool = False

    def data_type(self, schema):
        return self.to

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Cast(kids[0], self.to, self.ansi)

    @staticmethod
    def supported(src: T.DataType, dst: T.DataType, ansi: bool) -> bool:
        """True for the pairs this module evaluates."""
        if src == dst:
            return True
        return not (ansi or src.is_string or dst.is_string)

    def eval(self, ctx: EvalContext) -> ColumnVector:
        c = self.child.eval(ctx)
        src, dst = c.dtype, self.to
        if src == dst:
            return c
        if not self.supported(src, dst, self.ansi):
            raise NotImplementedError(
                f"cast {src} -> {dst}{' (ANSI)' if self.ansi else ''} is "
                f"not ported")
        if dst.id == T.TypeId.BOOL:
            return ColumnVector(T.BOOL, c.data != 0, c.validity)
        if src.id == T.TypeId.BOOL:
            return ColumnVector(dst, c.data.to(dst.torch_dtype), c.validity)
        if src.is_floating and dst.is_integral:
            return _float_to_int(c, dst)
        return ColumnVector(dst, c.data.to(dst.torch_dtype), c.validity)

    def __repr__(self):
        return f"cast({self.child!r} as {self.to})"


def _float_to_int(c: ColumnVector, dst: T.DataType) -> ColumnVector:
    """Truncate toward zero; NaN -> 0; saturate at the bounds by explicit
    selects (a float's conversion past the range is undefined)."""
    lo, hi = _INT_BOUNDS[dst.id if dst.id in _INT_BOUNDS else T.TypeId.INT64]
    x = c.data
    trunc = torch.trunc(torch.where(torch.isnan(x), 0.0, x))
    over = trunc >= float(hi)
    under = trunc <= float(lo)
    safe = torch.where(over | under, 0.0, trunc).to(torch.int64)
    data = torch.where(over, hi, torch.where(under, lo, safe))
    return ColumnVector(dst, data.to(dst.torch_dtype), c.validity)
