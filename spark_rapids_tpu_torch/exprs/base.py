"""Expression protocol (port of spark_rapids_tpu/exprs/base.py).

`Expression.eval(ctx)` returns a ColumnVector of torch tensors on the
context's device.  Null semantics follow Spark: most ops propagate nulls
(result validity = AND of child validities).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    bucket_char_cap)


@dataclasses.dataclass(eq=False)
class EvalContext:
    """Per-batch evaluation context: the input columns, the static
    capacity, the row count and the valid-row mask (all on one device)."""
    columns: list[ColumnVector]
    capacity: int
    num_rows: Any  # int32 device scalar
    row_mask: torch.Tensor  # bool[capacity]
    #: per-evaluation memo of common-subexpression slots
    #: (exprs/simplify.py SharedExpr)
    shared: dict = dataclasses.field(default_factory=dict)

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
        return self.map_children(lambda c: c.bind(schema))

    def map_children(self, fn) -> "Expression":
        """`fn` applied to every child; self when nothing changes, so
        rewrites can detect no-ops."""
        kids = self.children()
        if not kids:
            return self
        new = [fn(c) for c in kids]
        if all(n is o for n, o in zip(new, kids)):
            return self
        return self.with_children(new)

    def with_children(self, new_children) -> "Expression":
        raise NotImplementedError(type(self))

    # sugar -----------------------------------------------------------------
    def __add__(self, o): return _binop("Add", self, _lit(o))
    def __sub__(self, o): return _binop("Subtract", self, _lit(o))
    def __mul__(self, o): return _binop("Multiply", self, _lit(o))
    def __truediv__(self, o): return _binop("Divide", self, _lit(o))
    def __mod__(self, o): return _binop("Remainder", self, _lit(o))
    def __gt__(self, o): return _binop("GreaterThan", self, _lit(o))
    def __ge__(self, o): return _binop("GreaterThanOrEqual", self, _lit(o))
    def __lt__(self, o): return _binop("LessThan", self, _lit(o))
    def __le__(self, o): return _binop("LessThanOrEqual", self, _lit(o))
    # == and != build expressions too (expression dataclasses use
    # eq=False, so these are not shadowed): col("a") == 0 reads as in Spark
    def __eq__(self, o): return _binop("EqualTo", self, _lit(o))

    def __ne__(self, o):
        from spark_rapids_tpu_torch.exprs.predicates import Not
        return Not(_binop("EqualTo", self, _lit(o)))
    __hash__ = object.__hash__

    def __and__(self, o):
        from spark_rapids_tpu_torch.exprs.predicates import And
        return And(self, _lit(o))

    def __or__(self, o):
        from spark_rapids_tpu_torch.exprs.predicates import Or
        return Or(self, _lit(o))

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
            elif isinstance(v, str):
                dtype = T.STRING
            else:
                raise TypeError(f"unsupported literal {v!r}")
        return Literal(v, dtype)

    def data_type(self, schema) -> T.DataType:
        return self.dtype

    def eval(self, ctx: EvalContext) -> ColumnVector:
        cap = ctx.capacity
        if self.dtype.is_string:
            raw = b"" if self.value is None else \
                str(self.value).encode("utf-8")
            row = np.zeros(bucket_char_cap(len(raw)), np.uint8)
            row[:len(raw)] = np.frombuffer(raw, np.uint8)
            data = torch.from_numpy(row).to(ctx.device).expand(cap, -1)
            valid = (ctx.row_mask if self.value is not None else
                     torch.zeros(cap, dtype=torch.bool, device=ctx.device))
            return ColumnVector(self.dtype, data.contiguous(), valid,
                                lengths=torch.where(valid, len(raw), 0).to(
                                    torch.int32))
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


class UnaryExpression(Expression):
    """Null-propagating unary op."""
    child: Expression

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return type(self)(kids[0])

    def eval(self, ctx: EvalContext) -> ColumnVector:
        return self.do_columnar(self.child.eval(ctx), ctx)

    def do_columnar(self, c, ctx) -> ColumnVector:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.child!r})"


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


def fingerprint(obj) -> tuple:
    """Structural fingerprint of expression trees and dataclass specs:
    equal fingerprints evaluate alike (common-subexpression dedup keys
    on it)."""
    if obj is None:
        return ("~",)
    if isinstance(obj, (list, tuple)):
        return ("seq",) + tuple(fingerprint(x) for x in obj)
    if isinstance(obj, Expression) or dataclasses.is_dataclass(obj):
        out = [type(obj).__name__]
        if dataclasses.is_dataclass(obj):
            out.extend(fingerprint(getattr(obj, f.name))
                       for f in dataclasses.fields(obj))
        else:
            out.append(tuple(fingerprint(c) for c in obj.children()))
        return tuple(out)
    if isinstance(obj, T.DataType):
        return ("dt", str(obj))
    if isinstance(obj, T.Schema):
        return ("schema",) + tuple((f.name, str(f.dtype))
                                   for f in obj.fields)
    if isinstance(obj, (str, int, float, bool, bytes)):
        return ("v", type(obj).__name__, obj)
    return ("r", repr(obj))
