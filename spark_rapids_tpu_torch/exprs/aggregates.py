"""Aggregate functions (port of spark_rapids_tpu/exprs/aggregates.py: Sum,
Count/CountStar, Average).

Aggregation over the sort lane is segment ops over rows sorted by group:
the exec sorts rows by key, marks segment starts (`bounds`), and each
function contributes update / merge / evaluate stages, so partial and final
aggregation split exactly like Spark's.  Per-group reductions are
segmented inclusive scans read at each segment's last row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import Expression


def _segscan(combine_vals, bounds, *vals):
    """Segmented inclusive scan over rows SORTED by group: the carry
    resets at each segment start (`bounds`).  Recursive pair-combine, the
    same expansion as the reference's, so float sums add in the same
    order.  `combine_vals(a_vals, b_vals)` combines two ADJACENT spans'
    value tuples (left, right)."""

    def rec(f, vs):
        k = f.shape[0]
        if k == 1:
            return vs
        if k % 2:
            # odd length: the appended row starts its own segment, so it
            # never contaminates a carry; sliced off on the way out
            f = torch.cat([f, f.new_ones(1)])
            vs = tuple(torch.cat([v, v[-1:]]) for v in vs)
            return tuple(v[:k] for v in rec(f, vs))
        h = k // 2
        f2 = f.reshape(h, 2)
        fa, fb = f2[:, 0], f2[:, 1]
        va = tuple(v.reshape(h, 2)[:, 0] for v in vs)
        vb = tuple(v.reshape(h, 2)[:, 1] for v in vs)
        merged = combine_vals(va, vb)
        v_pair = tuple(torch.where(fb, b, m) for b, m in zip(vb, merged))
        vp = rec(fa | fb, v_pair)
        # exclusive carry into pair i = inclusive result of pair i-1
        vx = tuple(torch.cat([v[:1], v[:-1]]) for v in vp)
        no_carry = fa | (torch.arange(h, device=f.device) == 0)
        comb_e = combine_vals(vx, va)
        out_even = tuple(torch.where(no_carry, a, c)
                         for a, c in zip(va, comb_e))
        # interleave: out[2i] = even_i, out[2i+1] = pair-inclusive_i
        return tuple(torch.stack([e, o], dim=1).reshape(k)
                     for e, o in zip(out_even, vp))

    return rec(bounds, vals)


class ScanBatch:
    """Cross-function segmented-scan batcher: aggregate functions register
    per-row operands (`seg(op, arr)`), and one `_segscan` per round runs
    over all of them.  Handles resolve to per-GROUP results (read at
    segment ends) after `run_round()`."""

    def __init__(self, ctx: "AggContext"):
        self._ctx = ctx
        self._pend: list = []       # (handle, row array) this round
        self._results: dict = {}    # handle -> per-group result
        # (id(arr)) -> (handle, arr): the array is held so its id() is
        # not reused by a later operand
        self._dedup: dict = {}
        self._count = 0

    def seg(self, op: str, arr) -> int:
        if op != "add":
            raise NotImplementedError(f"segment op {op!r}")
        hit = self._dedup.get(id(arr))
        if hit is not None:
            return hit[0]
        h = self._count
        self._count += 1
        self._pend.append((h, arr))
        self._dedup[id(arr)] = (h, arr)
        return h

    def run_round(self) -> None:
        if not self._pend:
            return
        idxs = [h for h, _ in self._pend]
        arrs = [a for _, a in self._pend]
        runs = _segscan(lambda a, b: tuple(x + y for x, y in zip(a, b)),
                        self._ctx.bounds, *arrs)
        ends = self._ctx.ends.to(torch.int64)
        for h, r in zip(idxs, runs):
            self._results[h] = r[ends]
        self._pend = []

    def result(self, h: int):
        return self._results[h]


def run_agg_phase(actx: "AggContext", funcs, inputs_per_f, phase: str):
    """Drive every aggregate function's update/merge generator with
    cross-function scan batching; returns the per-function output tuples
    in order."""
    scans = ScanBatch(actx)
    slots: list = []
    live: list = []
    for f, ins in zip(funcs, inputs_per_f):
        gen = (f.update_scans(actx, scans, ins) if phase == "update"
               else f.merge_scans(actx, scans, ins))
        next(gen)
        slots.append(None)
        live.append((len(slots) - 1, gen))
    while live:
        scans.run_round()
        nxt = []
        for i, gen in live:
            try:
                next(gen)
                nxt.append((i, gen))
            except StopIteration as e:
                slots[i] = e.value
        live = nxt
    return slots


@dataclasses.dataclass
class AggContext:
    seg_ids: torch.Tensor     # per sorted row
    capacity: int             # row-side length (input rows)
    row_valid: torch.Tensor   # sorted row mask
    #: True at each sorted row that STARTS a group (invalid rows never
    #: start one — they ride the last group's segment id)
    bounds: torch.Tensor
    #: per-SEGMENT index of its last sorted row (out_capacity-length;
    #: entries at or past the group count are arbitrary, must be masked)
    ends: torch.Tensor
    #: GROUP-side output length
    out_capacity: Optional[int] = None

    def __post_init__(self):
        if self.out_capacity is None:
            self.out_capacity = self.capacity

    @property
    def device(self) -> torch.device:
        return self.bounds.device


class AggregateFunction:
    """One aggregate; `child` is None for Count(*).

    `update_scans` / `merge_scans` return a GENERATOR that registers its
    operands on the shared ScanBatch, yields once per scan round, and
    returns its output column tuple."""
    child: Optional[Expression]

    def input_exprs(self) -> Sequence[Expression]:
        return () if self.child is None else (self.child,)

    def result_type(self, schema: T.Schema) -> T.DataType:
        raise NotImplementedError

    def intermediate_types(self, schema: T.Schema) -> Sequence[T.DataType]:
        raise NotImplementedError

    # FINAL-mode type resolution: a merge-side exec sees only the partial
    # schema (keys + intermediates), so counts and result types must be
    # derivable positionally.
    @property
    def num_intermediates(self) -> int:
        return 1

    def result_from_intermediates(
            self, inter: Sequence[T.DataType]) -> T.DataType:
        return inter[0]

    def update_scans(self, ctx, scans, inputs):
        raise NotImplementedError

    def merge_scans(self, ctx, scans, partials):
        raise NotImplementedError

    def evaluate(self, partials: Sequence[ColumnVector],
                 schema: T.Schema) -> ColumnVector:
        raise NotImplementedError

    def alias(self, name: str):
        return AggAlias(self, name)


@dataclasses.dataclass
class AggAlias:
    func: AggregateFunction
    name: str


def _sum_type(dt: T.DataType) -> T.DataType:
    return T.FLOAT64 if dt.is_floating else T.INT64


def _always(ctx: AggContext) -> torch.Tensor:
    return torch.ones(ctx.out_capacity, dtype=torch.bool, device=ctx.device)


@dataclasses.dataclass
class Sum(AggregateFunction):
    """Spark: sum(int*) -> long, sum(float*) -> double; null only when
    every input in the group is null."""
    child: Expression

    def result_type(self, schema):
        return _sum_type(self.child.data_type(schema))

    def intermediate_types(self, schema):
        return (self.result_type(schema),)

    def evaluate(self, partials, schema):
        return partials[0]

    def update_scans(self, ctx, scans, inputs):
        (v,) = inputs
        dt = _sum_type(v.dtype)

        def gen():
            ok = v.validity & ctx.row_valid
            hs = scans.seg("add", torch.where(
                ok, v.data.to(dt.torch_dtype), 0))
            hc = scans.seg("add", ok.to(torch.int32))
            yield
            return (ColumnVector(dt, scans.result(hs),
                                 scans.result(hc) > 0),)
        return gen()

    def merge_scans(self, ctx, scans, partials):
        (p,) = partials

        def gen():
            ok = p.validity & ctx.row_valid
            hs = scans.seg("add", torch.where(ok, p.data, 0))
            hc = scans.seg("add", ok.to(torch.int32))
            yield
            return (ColumnVector(p.dtype, scans.result(hs),
                                 scans.result(hc) > 0),)
        return gen()


@dataclasses.dataclass
class Count(AggregateFunction):
    """Count(expr) counts non-null; Count(None) == COUNT(*)."""
    child: Optional[Expression] = None

    def result_type(self, schema):
        return T.INT64

    def intermediate_types(self, schema):
        return (T.INT64,)

    def evaluate(self, partials, schema):
        return partials[0]

    def update_scans(self, ctx, scans, inputs):
        def gen():
            ok = ctx.row_valid if self.child is None \
                else inputs[0].validity & ctx.row_valid
            h = scans.seg("add", ok.to(torch.int32))
            yield
            return (ColumnVector(T.INT64, scans.result(h).to(torch.int64),
                                 _always(ctx)),)
        return gen()

    def merge_scans(self, ctx, scans, partials):
        (p,) = partials

        def gen():
            ok = p.validity & ctx.row_valid
            h = scans.seg("add", torch.where(ok, p.data, 0))
            yield
            return (ColumnVector(T.INT64, scans.result(h), _always(ctx)),)
        return gen()


def CountStar() -> Count:
    return Count(None)


@dataclasses.dataclass
class Average(AggregateFunction):
    """Spark avg -> double; intermediates are (sum: double, count: long)."""
    child: Expression

    def result_type(self, schema):
        return T.FLOAT64

    def intermediate_types(self, schema):
        return (T.FLOAT64, T.INT64)

    num_intermediates = 2

    def result_from_intermediates(self, inter):
        return T.FLOAT64

    def update_scans(self, ctx, scans, inputs):
        (v,) = inputs

        def gen():
            ok = v.validity & ctx.row_valid
            hs = scans.seg("add", torch.where(
                ok, v.data.to(torch.float64), 0.0))
            hc = scans.seg("add", ok.to(torch.int32))
            yield
            return (ColumnVector(T.FLOAT64, scans.result(hs), _always(ctx)),
                    ColumnVector(T.INT64, scans.result(hc).to(torch.int64),
                                 _always(ctx)))
        return gen()

    def merge_scans(self, ctx, scans, partials):
        s_p, c_p = partials

        def gen():
            ok = ctx.row_valid
            hs = scans.seg("add", torch.where(ok, s_p.data, 0.0))
            hc = scans.seg("add", torch.where(ok, c_p.data, 0))
            yield
            return (ColumnVector(T.FLOAT64, scans.result(hs), _always(ctx)),
                    ColumnVector(T.INT64, scans.result(hc), _always(ctx)))
        return gen()

    def evaluate(self, partials, schema):
        s, c = partials
        nonzero = c.data > 0
        avg = s.data / torch.where(nonzero, c.data, 1).to(torch.float64)
        return ColumnVector(T.FLOAT64, avg, nonzero)
