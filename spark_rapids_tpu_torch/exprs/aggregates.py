"""Aggregate functions (port of spark_rapids_tpu/exprs/aggregates.py: Sum,
Count/CountStar, Average/Avg, Min, Max, First, Last, VarianceSamp and
StddevSamp).

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

#: the identity of min / max per integral type: what a masked row holds
_INT_MIN = {T.TypeId.INT8: -(2 ** 7), T.TypeId.INT16: -(2 ** 15),
            T.TypeId.INT32: -(2 ** 31), T.TypeId.INT64: -(2 ** 63),
            T.TypeId.DATE32: -(2 ** 31), T.TypeId.TIMESTAMP_US: -(2 ** 63),
            T.TypeId.BOOL: 0}
_INT_MAX = {T.TypeId.INT8: 2 ** 7 - 1, T.TypeId.INT16: 2 ** 15 - 1,
            T.TypeId.INT32: 2 ** 31 - 1, T.TypeId.INT64: 2 ** 63 - 1,
            T.TypeId.DATE32: 2 ** 31 - 1, T.TypeId.TIMESTAMP_US: 2 ** 63 - 1,
            T.TypeId.BOOL: 1}

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


_SCAN_OPS = {
    "add": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
}


class ScanBatch:
    """Cross-function segmented-scan batcher: aggregate functions register
    per-row operands (`seg(op, arr)`), and one `_segscan` per round runs
    over all of them, each combined with its own op.  Handles resolve to
    per-GROUP results (read at segment ends) after `run_round()`."""

    def __init__(self, ctx: "AggContext"):
        self._ctx = ctx
        self._ops: list = []        # combine-op name per handle
        self._pend: list = []       # (handle, row array) this round
        self._results: dict = {}    # handle -> per-group result
        # (op, id(arr)) -> (handle, arr): the array is held so its id()
        # is not reused by a later operand
        self._dedup: dict = {}

    def seg(self, op: str, arr) -> int:
        key = (op, id(arr))
        hit = self._dedup.get(key)
        if hit is not None:
            return hit[0]
        h = len(self._ops)
        self._ops.append(op)
        self._pend.append((h, arr))
        self._dedup[key] = (h, arr)
        return h

    def run_round(self) -> None:
        if not self._pend:
            return
        idxs = [h for h, _ in self._pend]
        arrs = [a for _, a in self._pend]
        ops = [_SCAN_OPS[self._ops[h]] for h in idxs]

        def combine(a, b):
            return tuple(op(x, y) for op, x, y in zip(ops, a, b))

        runs = _segscan(combine, self._ctx.bounds, *arrs)
        ends = self._ctx.ends.to(torch.int64)
        for h, r in zip(idxs, runs):
            self._results[h] = r[ends]
        self._pend = []

    def result(self, h: int):
        return self._results[h]


def run_agg_phase(actx: "AggContext", funcs, inputs_per_f, phase: str):
    """Drive every aggregate function's update/merge generator with
    cross-function scan batching; returns the per-function output tuples
    in order.  A function whose `update_scans` / `merge_scans` gives None
    (Min/Max over strings) runs its eager `update` / `merge` instead."""
    scans = ScanBatch(actx)
    slots: list = []
    live: list = []
    for f, ins in zip(funcs, inputs_per_f):
        gen = (f.update_scans(actx, scans, ins) if phase == "update"
               else f.merge_scans(actx, scans, ins))
        if gen is None:
            slots.append(f.update(actx, ins) if phase == "update"
                         else f.merge(actx, ins))
            continue
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


def _sorted_seg_sum(vals, ctx: "AggContext"):
    """Per-group sums of `vals` over rows sorted by group (invalid rows
    already zeroed), read at the segment ends."""
    (run,) = _segscan(lambda a, b: (a[0] + b[0],), ctx.bounds, vals)
    return run[ctx.ends.to(torch.int64)]


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


def _minmax_numeric_gen(v: ColumnVector, ctx: AggContext,
                        scans: ScanBatch, is_min: bool):
    """Segment min/max with Spark's NaN rule: NaN is the largest value,
    so it is the max of any group that holds one, and the min only of a
    group of NaNs alone.  Generator (ScanBatch protocol): yields once,
    returns (values, has a value).  Scans run at the column's own
    width."""
    op = "min" if is_min else "max"
    ok = v.validity & ctx.row_valid
    if v.dtype.is_floating:
        nan = torch.isnan(v.data) & ok
        non_nan = ok & ~nan
        fill = float("inf") if is_min else float("-inf")
        hr = scans.seg(op, torch.where(non_nan, v.data, fill))
        hc = scans.seg("add", ok.to(torch.int32))
        hn = scans.seg("add", non_nan.to(torch.int32))
        yield
        red = scans.result(hr)
        cnt, n_non_nan = scans.result(hc), scans.result(hn)
        has = cnt > 0
        if is_min:
            red = torch.where(has & (n_non_nan == 0), float("nan"), red)
        else:
            red = torch.where(cnt > n_non_nan, float("nan"), red)
        return red.to(v.dtype.torch_dtype), has
    fill = (_INT_MAX if is_min else _INT_MIN)[v.dtype.id]
    hr = scans.seg(op, torch.where(ok, v.data, torch.tensor(
        fill, dtype=v.data.dtype, device=v.data.device)))
    hh = scans.seg("add", ok.to(torch.int32))
    yield
    return scans.result(hr).to(v.dtype.torch_dtype), scans.result(hh) > 0


@dataclasses.dataclass
class _MinMax(AggregateFunction):
    child: Expression

    def result_type(self, schema):
        return self.child.data_type(schema)

    def intermediate_types(self, schema):
        return (self.child.data_type(schema),)

    def update_scans(self, ctx, scans, inputs):
        (v,) = inputs
        if v.dtype.is_string:
            return None  # the eager string lane, `update`

        def gen():
            red, has = yield from _minmax_numeric_gen(v, ctx, scans,
                                                      self._is_min)
            return (ColumnVector(v.dtype, red, has),)
        return gen()

    def merge_scans(self, ctx, scans, partials):
        return self.update_scans(ctx, scans, partials)

    def merge(self, ctx, partials):
        return self.update(ctx, partials)

    def evaluate(self, partials, schema):
        return partials[0]

    def update(self, ctx, inputs):
        """Strings: argmin/argmax by byte-lexicographic rank.  The rows
        sort by (segment, null or masked last, value); every segment keeps
        all its rows, so the s-th run of the sorted segment ids is segment
        s and its first row is the winner."""
        from spark_rapids_tpu_torch.ops.sort_encode import (encode_key_bits,
                                                            masked_positions,
                                                            packed_lexsort)
        (v,) = inputs
        cap = ctx.capacity
        ok = v.validity & ctx.row_valid
        keys = encode_key_bits(v, ascending=self._is_min, nulls_first=False)
        seg = ctx.seg_ids.to(torch.int64) & 0xFFFFFFFF
        order = packed_lexsort([(seg, 32), ((~ok).to(torch.int64), 1)]
                               + keys)
        seg_sorted = ctx.seg_ids[order]
        isfirst = torch.cat([torch.ones(1, dtype=torch.bool,
                                        device=ctx.device),
                             seg_sorted[1:] != seg_sorted[:-1]])
        pos = masked_positions(isfirst, ctx.out_capacity, fill_value=cap - 1)
        idx = order[pos]
        # a group whose rows are all null or masked sorted one of them
        # first anyway: `has` masks it out
        has = _sorted_seg_sum(ok.to(torch.int32), ctx) > 0
        return (v.gather(idx, has),)


class Min(_MinMax):
    _is_min = True


class Max(_MinMax):
    _is_min = False


@dataclasses.dataclass
class _FirstLast(AggregateFunction):
    """The value of the first (last) row of each group; with
    ignore_nulls the first (last) non-null one, else the raw row's,
    null or not."""
    child: Expression
    ignore_nulls: bool = False

    def result_type(self, schema):
        return self.child.data_type(schema)

    def intermediate_types(self, schema):
        return (self.child.data_type(schema),)

    def update_scans(self, ctx, scans, inputs):
        (v,) = inputs

        def gen():
            cap = ctx.capacity
            ok = ctx.row_valid & v.validity if self.ignore_nulls \
                else ctx.row_valid
            rows = torch.arange(cap, dtype=torch.int32, device=ctx.device)
            if self._is_first:
                hp = scans.seg("min", torch.where(ok, rows, cap))
            else:
                hp = scans.seg("max", torch.where(ok, rows, -1))
            hh = scans.seg("add", ok.to(torch.int32))
            yield
            has = scans.result(hh) > 0
            idx = torch.where(has, scans.result(hp), 0)
            return (v.gather(idx, has),)
        return gen()

    def merge_scans(self, ctx, scans, partials):
        return self.update_scans(ctx, scans, partials)

    def evaluate(self, partials, schema):
        return partials[0]


class First(_FirstLast):
    _is_first = True


class Last(_FirstLast):
    _is_first = False


def Avg(e: Expression) -> Average:
    return Average(e)


@dataclasses.dataclass
class VarianceSamp(AggregateFunction):
    """Spark's var_samp -> double.  Intermediates (count, mean, m2) with
    a Welford/Chan merge, Spark's CentralMomentAgg layout, in two scan
    rounds: the sums and counts, then the squares about the group mean.
    Null for a group with fewer than two non-null values."""
    child: Expression

    def result_type(self, schema):
        return T.FLOAT64

    def intermediate_types(self, schema):
        return (T.INT64, T.FLOAT64, T.FLOAT64)

    num_intermediates = 3

    def result_from_intermediates(self, inter):
        return T.FLOAT64

    @staticmethod
    def _per_row(group_vals, ctx):
        idx = ctx.seg_ids.to(torch.int64).clamp(0, ctx.out_capacity - 1)
        return group_vals[idx]

    def update_scans(self, ctx, scans, inputs):
        (v,) = inputs

        def gen():
            ok = v.validity & ctx.row_valid
            x = torch.where(ok, v.data.to(torch.float64), 0.0)
            hs = scans.seg("add", x)
            hc = scans.seg("add", ok.to(torch.int32))
            yield
            c = scans.result(hc).to(torch.int64)
            mean = scans.result(hs) / torch.clamp(c, min=1).to(
                torch.float64)
            d = torch.where(ok, x - self._per_row(mean, ctx), 0.0)
            hm = scans.seg("add", d * d)
            yield
            return (ColumnVector(T.INT64, c, _always(ctx)),
                    ColumnVector(T.FLOAT64, mean, _always(ctx)),
                    ColumnVector(T.FLOAT64, scans.result(hm), _always(ctx)))
        return gen()

    def merge_scans(self, ctx, scans, partials):
        c_p, mean_p, m2_p = partials

        def gen():
            ok = ctx.row_valid
            cr = torch.where(ok, c_p.data, 0)
            crf = cr.to(torch.float64)
            hc = scans.seg("add", cr)
            hs = scans.seg("add", torch.where(ok, mean_p.data * crf, 0.0))
            yield
            c = scans.result(hc)
            mean = scans.result(hs) / torch.clamp(c, min=1).to(
                torch.float64)
            # Chan: m2 = sum_i(m2_i + c_i * (mean_i - mean)^2)
            delta = mean_p.data - self._per_row(mean, ctx)
            contrib = torch.where(ok, m2_p.data + crf * delta * delta, 0.0)
            hm = scans.seg("add", contrib)
            yield
            return (ColumnVector(T.INT64, c, _always(ctx)),
                    ColumnVector(T.FLOAT64, mean, _always(ctx)),
                    ColumnVector(T.FLOAT64, scans.result(hm), _always(ctx)))
        return gen()

    def _var(self, partials):
        c, _mean, m2 = partials
        ok = c.data > 1
        denom = torch.where(ok, c.data.to(torch.float64) - 1.0, 1.0)
        return m2.data / denom, ok

    def evaluate(self, partials, schema):
        var, ok = self._var(partials)
        return ColumnVector(T.FLOAT64, var, ok)


@dataclasses.dataclass
class StddevSamp(VarianceSamp):
    """Spark's stddev_samp -> double: the square root of var_samp."""

    def evaluate(self, partials, schema):
        var, ok = self._var(partials)
        return ColumnVector(T.FLOAT64, torch.sqrt(var), ok)
