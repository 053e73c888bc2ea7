"""Expression protocol (port of spark_rapids_tpu/exprs/base.py).

`Expression.eval(ctx)` returns a ColumnVector of torch tensors on the
context's device.  Null semantics follow Spark: most ops propagate nulls
(result validity = AND of child validities).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector


@dataclasses.dataclass(eq=False)
class EvalContext:
    """Per-batch evaluation context: the input columns, the static
    capacity, the row count and the valid-row mask (all on one device)."""
    columns: list[ColumnVector]
    capacity: int
    num_rows: Any  # int32 device scalar
    row_mask: torch.Tensor  # bool[capacity]

    @property
    def device(self) -> torch.device:
        return self.row_mask.device


class Expression:
    """Base of the columnar expression tree."""

    def data_type(self, input_schema: T.Schema) -> T.DataType:
        raise NotImplementedError

    def children(self) -> Sequence["Expression"]:
        return ()

    def eval(self, ctx: EvalContext) -> ColumnVector:
        raise NotImplementedError

    def bind(self, schema: T.Schema) -> "Expression":
        """Resolve column names to positions."""
        kids = self.children()
        if not kids:
            return self
        new = [c.bind(schema) for c in kids]
        if all(n is o for n, o in zip(new, kids)):
            return self
        return self.with_children(new)

    def with_children(self, new_children) -> "Expression":
        raise NotImplementedError(type(self))

    # sugar -----------------------------------------------------------------
    def __add__(self, o): return _binop("Add", self, _lit(o))
    def __sub__(self, o): return _binop("Subtract", self, _lit(o))
    def __mul__(self, o): return _binop("Multiply", self, _lit(o))
    def __le__(self, o): return _binop("LessThanOrEqual", self, _lit(o))
    __hash__ = object.__hash__

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)


def _lit(v):
    return v if isinstance(v, Expression) else Literal.of(v)


def _binop(name, left, right):
    from spark_rapids_tpu_torch.exprs import arithmetic, predicates
    for mod in (arithmetic, predicates):
        if hasattr(mod, name):
            return getattr(mod, name)(left, right)
    raise KeyError(name)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class AttributeReference(Expression):
    """Unresolved column-by-name; becomes BoundReference at bind time."""
    name: str

    def data_type(self, schema: T.Schema) -> T.DataType:
        return schema.field(self.name).dtype

    def bind(self, schema: T.Schema) -> Expression:
        return BoundReference(schema.index(self.name),
                              schema.field(self.name).dtype)

    def eval(self, ctx):
        raise RuntimeError(f"unbound attribute {self.name}")

    def __repr__(self):
        return self.name


def col(name: str) -> AttributeReference:
    return AttributeReference(name)


@dataclasses.dataclass(eq=False)
class BoundReference(Expression):
    """Positional column reference."""
    ordinal: int
    dtype: T.DataType

    def data_type(self, schema) -> T.DataType:
        return self.dtype

    def eval(self, ctx: EvalContext) -> ColumnVector:
        return ctx.columns[self.ordinal]

    def __repr__(self):
        return f"input[{self.ordinal}]"


@dataclasses.dataclass(eq=False)
class Literal(Expression):
    """Typed literal, broadcast to the batch capacity at eval.  A Python
    float is a DOUBLE and an int an INT (LONG past the int range), as in
    Spark."""
    value: Any
    dtype: T.DataType

    @staticmethod
    def of(v: Any, dtype: Optional[T.DataType] = None) -> "Literal":
        if dtype is None:
            if v is None:
                raise TypeError("null literal needs explicit dtype")
            if isinstance(v, bool):
                dtype = T.BOOL
            elif isinstance(v, int):
                dtype = T.INT32 if -2**31 <= v < 2**31 else T.INT64
            elif isinstance(v, float):
                dtype = T.FLOAT64
            else:
                raise TypeError(f"unsupported literal {v!r}")
        return Literal(v, dtype)

    def data_type(self, schema) -> T.DataType:
        return self.dtype

    def eval(self, ctx: EvalContext) -> ColumnVector:
        cap = ctx.capacity
        if self.value is None:
            return ColumnVector(
                self.dtype,
                torch.zeros(cap, dtype=self.dtype.torch_dtype,
                            device=ctx.device),
                torch.zeros(cap, dtype=torch.bool, device=ctx.device))
        data = torch.full((cap,), self.value, dtype=self.dtype.torch_dtype,
                          device=ctx.device)
        return ColumnVector(self.dtype, data, ctx.row_mask)

    def __repr__(self):
        return f"lit({self.value!r})"


def lit(v: Any, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal.of(v, dtype)


@dataclasses.dataclass(eq=False)
class Alias(Expression):
    child: Expression
    name: str

    def data_type(self, schema):
        return self.child.data_type(schema)

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Alias(kids[0], self.name)

    def eval(self, ctx):
        return self.child.eval(ctx)

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


def output_name(e: Expression, idx: int) -> str:
    if isinstance(e, (Alias, AttributeReference)):
        return e.name
    return f"col{idx}"


class BinaryExpression(Expression):
    """Null-propagating binary op."""
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return type(self)(kids[0], kids[1])

    def eval(self, ctx: EvalContext) -> ColumnVector:
        return self.do_columnar(self.left.eval(ctx), self.right.eval(ctx),
                                ctx)

    def do_columnar(self, l, r, ctx) -> ColumnVector:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.left!r}, {self.right!r})"


def numeric_result_type(schema, *exprs) -> T.DataType:
    dts = [e.data_type(schema) for e in exprs]
    out = dts[0]
    for dt in dts[1:]:
        out = T.common_type(out, dt)
    return out


def promote(v: ColumnVector, dt: T.DataType) -> ColumnVector:
    if v.dtype == dt:
        return v
    return ColumnVector(dt, v.data.to(dt.torch_dtype), v.validity)
