"""Complex-type extractors over inline constructors (port of
spark_rapids_tpu/exprs/complex.py): GetArrayItem, GetMapValue,
CreateArray and CreateMap.

The type matrix has no array or map column, as in the reference.  What
runs on the device is an extractor over an inline construction, with no
list column ever made:

  - GetArrayItem(StringSplit(...)): the fused split-part function;
  - GetArrayItem(CreateArray(...)): a per-row select over the evaluated
    element columns;
  - GetMapValue(CreateMap(...)): the value of the first key that
    matches.

A bare CreateArray, CreateMap or StringSplit is left on the CPU by the
planner.
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector, _pad_chars
from spark_rapids_tpu_torch.exprs.base import (EvalContext, Expression,
                                               promote)


def _common(dts) -> T.DataType:
    dt = dts[0]
    for d2 in dts[1:]:
        if d2 != dt:
            dt = T.common_type(dt, d2)
    return dt


@dataclasses.dataclass(eq=False, init=False)
class CreateArray(Expression):
    """array(e1, ..., eN): evaluated only through GetArrayItem."""
    elements: tuple

    def __init__(self, elements):
        self.elements = tuple(elements)

    def element_type(self, schema) -> T.DataType:
        return _common([e.data_type(schema) for e in self.elements])

    def data_type(self, schema):
        return self.element_type(schema)

    def children(self):
        return self.elements

    def with_children(self, kids):
        return CreateArray(tuple(kids))

    def eval(self, ctx):
        raise TypeError("CreateArray must be consumed by GetArrayItem (the "
                        "type matrix has no array columns)")


@dataclasses.dataclass(eq=False, init=False)
class CreateMap(Expression):
    """map(k1, v1, ..., kN, vN): evaluated only through GetMapValue."""
    entries: tuple  # flat (k1, v1, k2, v2, ...)

    def __init__(self, entries):
        if not entries or len(entries) % 2:
            raise ValueError("map needs key/value pairs")
        self.entries = tuple(entries)

    def value_type(self, schema) -> T.DataType:
        return _common([e.data_type(schema) for e in self.entries[1::2]])

    def data_type(self, schema):
        return self.value_type(schema)

    def children(self):
        return self.entries

    def with_children(self, kids):
        return CreateMap(tuple(kids))

    def eval(self, ctx):
        raise TypeError("CreateMap must be consumed by GetMapValue (the "
                        "type matrix has no map columns)")


def _select_columns(masks, cols, dtype, cap, dev):
    """Per row, the first column whose mask is true (all columns of
    `dtype`; strings padded to one char capacity).  Returns (data,
    validity, lengths)."""
    if dtype.is_string:
        cc = max(c.char_cap for c in cols)
        cols = [_pad_chars(c, cc) for c in cols]
        data = torch.zeros((cap, cc), dtype=torch.uint8, device=dev)
        lengths = torch.zeros(cap, dtype=torch.int32, device=dev)
    else:
        data = torch.zeros(cap, dtype=dtype.torch_dtype, device=dev)
        lengths = None
    validity = torch.zeros(cap, dtype=torch.bool, device=dev)
    taken = torch.zeros(cap, dtype=torch.bool, device=dev)
    for m, c in zip(masks, cols):
        use = m & ~taken
        if dtype.is_string:
            data = torch.where(use[:, None], c.data, data)
            lengths = torch.where(use, c.lengths, lengths)
        else:
            data = torch.where(use, c.data, data)
        validity = torch.where(use, c.validity, validity)
        taken = taken | use
    return data, validity & taken, lengths


@dataclasses.dataclass(eq=False)
class GetArrayItem(Expression):
    """array[i]: an index out of range, or null, gives null (non-ANSI)."""
    child: Expression
    ordinal: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def children(self):
        return (self.child, self.ordinal)

    def with_children(self, kids):
        return GetArrayItem(kids[0], kids[1])

    def eval(self, ctx: EvalContext) -> ColumnVector:
        from spark_rapids_tpu_torch.exprs.string_fns import (StringSplit,
                                                             _split_part)
        ch = self.child
        nv = self.ordinal.eval(ctx)
        n = nv.data.to(torch.int32)
        if isinstance(ch, StringSplit):
            sc = ch.child.eval(ctx)
            out = _split_part(sc, ch.literal_pattern().encode(), n,
                              ch.literal_limit())
            return ColumnVector(T.STRING, out.data,
                                out.validity & nv.validity,
                                lengths=out.lengths)
        if isinstance(ch, CreateArray):
            cols = [e.eval(ctx) for e in ch.elements]
            dt = _common([c.dtype for c in cols])
            cols = [promote(c, dt) for c in cols]
            data, validity, lengths = _select_columns(
                [n == k for k in range(len(cols))], cols, dt, ctx.capacity,
                ctx.device)
            return ColumnVector(dt, data, validity & nv.validity,
                                lengths=lengths)
        raise TypeError(f"GetArrayItem over {type(ch).__name__} is not "
                        f"supported (the type matrix has no array columns)")


@dataclasses.dataclass(eq=False)
class GetMapValue(Expression):
    """map[key]: the value of the first entry whose key equals the lookup
    key; null when none does."""
    child: Expression
    key: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def children(self):
        return (self.child, self.key)

    def with_children(self, kids):
        return GetMapValue(kids[0], kids[1])

    def eval(self, ctx: EvalContext) -> ColumnVector:
        from spark_rapids_tpu_torch.exprs.predicates import _compare
        ch = self.child
        if not isinstance(ch, CreateMap):
            raise TypeError(f"GetMapValue over {type(ch).__name__} is not "
                            f"supported (the type matrix has no map "
                            f"columns)")
        keyv = self.key.eval(ctx)
        keys = [e.eval(ctx) for e in ch.entries[0::2]]
        vals = [e.eval(ctx) for e in ch.entries[1::2]]
        dt = _common([c.dtype for c in vals])
        vals = [promote(c, dt) for c in vals]
        masks = []
        for kc in keys:
            _, eq = _compare(kc, keyv)
            masks.append(eq & kc.validity & keyv.validity)
        data, validity, lengths = _select_columns(masks, vals, dt,
                                                  ctx.capacity, ctx.device)
        return ColumnVector(dt, data, validity, lengths=lengths)
