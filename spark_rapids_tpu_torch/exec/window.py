"""Window operator (port of spark_rapids_tpu/exec/window.py): rows
frames, range frames over one integral order key, row_number, rank,
dense_rank, lead, lag and the min/max/sum/count/avg/first/last frame
aggregates.

Per batch: sort the rows by (partition keys, order keys), find the
partition segments, evaluate every function over the sorted layout, and
scatter the results back to the input row order.  Frame math is
vectorized:
  - running and sliding sums: one cumsum over the batch, read at the
    frame's two ends (the sums are float64 for floating and avg inputs,
    so each carries at most ~n*eps*sum|x| of rounding from the earlier
    segments it passes over);
  - min/max: a sparse table (doubling levels), read at the two
    power-of-two spans that cover the frame;
  - range frames: a binary search over the (segment, order value)
    order.

The exec needs its child coalesced to a single batch per partition
(RequireSingleBatch), as the reference does.  Wide PARTITION BY key sets
sort as two murmur3 words (`hash_prefix_sort_bounds`) under the same
collision check and deopt as the aggregate's hash lane.

`CpuWindow` is the planner node and its pandas evaluation, the CPU
engine's window.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exec.base import (CoalesceGoal,
                                              RequireSingleBatch, TpuExec,
                                              UnaryExecBase,
                                              make_eval_context, kp_site)
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.ops.sort_encode import (hash_prefix_sort_bounds,
                                                    masked_positions,
                                                    sort_with_prefix_bounds,
                                                    wide_key_set)
from spark_rapids_tpu_torch.plan.nodes import CpuNode
from spark_rapids_tpu_torch.utils import checks as CK

UNBOUNDED = None
CURRENT_ROW = 0

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """rows/range frame; bounds: None = unbounded, int offsets otherwise
    (negative = preceding, positive = following, 0 = current row)."""
    is_rows: bool = True
    lower: Optional[int] = UNBOUNDED   # default UNBOUNDED PRECEDING
    upper: Optional[int] = CURRENT_ROW  # default CURRENT ROW


@dataclasses.dataclass
class WindowSpec:
    partition_by: Sequence[Expression]
    order_by: Sequence[SortOrder] = ()
    frame: WindowFrame = WindowFrame()


@dataclasses.dataclass
class WindowFunction:
    kind: str                      # row_number, rank, dense_rank, lead,
    # lag, sum, min, max, count, avg, first, last
    child: Optional[Expression] = None
    offset: int = 1                # for lead/lag
    default: Optional[object] = None

    def alias(self, name):
        return (self, name)


def RowNumber():
    return WindowFunction("row_number")


def Rank():
    return WindowFunction("rank")


def DenseRank():
    return WindowFunction("dense_rank")


def Lead(e, offset=1, default=None):
    return WindowFunction("lead", e, offset, default)


def Lag(e, offset=1, default=None):
    return WindowFunction("lag", e, offset, default)


def WinSum(e):
    return WindowFunction("sum", e)


def WinMin(e):
    return WindowFunction("min", e)


def WinMax(e):
    return WindowFunction("max", e)


def WinCount(e):
    return WindowFunction("count", e)


def WinAvg(e):
    return WindowFunction("avg", e)


#: the functions WindowExec evaluates
KINDS = ("row_number", "rank", "dense_rank", "lead", "lag", "sum", "min",
         "max", "count", "avg", "first", "last")


def _result_type(fn: WindowFunction, schema) -> T.DataType:
    if fn.kind in ("row_number", "rank", "dense_rank"):
        return T.INT32
    if fn.kind == "count":
        return T.INT64
    if fn.kind == "avg":
        return T.FLOAT64
    dt = fn.child.data_type(schema)
    if fn.kind == "sum":
        return T.FLOAT64 if dt.is_floating else T.INT64
    return dt


def _named(window_exprs) -> list:
    """(WindowFunction, name) pairs; a bare function is named w<i>."""
    return [w if isinstance(w, tuple) else (w, f"w{i}")
            for i, w in enumerate(window_exprs)]


def _sat_add(x: torch.Tensor, off: int) -> torch.Tensor:
    """x + off in int64, saturating at the int64 ends (a range bound past
    them holds every row on that side)."""
    off = max(min(off, _I64_MAX), _I64_MIN)
    if off > 0:
        return torch.where(x > _I64_MAX - off, _I64_MAX, x + off)
    if off < 0:
        return torch.where(x < _I64_MIN - off, _I64_MIN, x + off)
    return x


def _lex_searchsorted(seg, vals, q_seg, q_vals, side: str, cap: int):
    """Vectorized binary search over rows sorted by (seg, vals): the
    first index where (seg, vals) > (q_seg, q_vals) ("right") or >=
    ("left")."""
    lo = torch.zeros_like(q_seg)
    hi = torch.full_like(q_seg, cap)
    steps = max(1, (max(cap, 2) - 1).bit_length() + 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        idx = mid.clamp(0, cap - 1)
        ms, mv = seg[idx], vals[idx]
        if side == "left":
            go_right = (ms < q_seg) | ((ms == q_seg) & (mv < q_vals))
        else:
            go_right = (ms < q_seg) | ((ms == q_seg) & (mv <= q_vals))
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _range_sum(prefix: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
               ) -> torch.Tensor:
    """The sum over [lo, hi) given inclusive prefix sums."""
    cap = prefix.shape[0]
    zero = torch.zeros((), dtype=prefix.dtype, device=prefix.device)
    hi_v = torch.where(hi > 0, prefix[(hi - 1).clamp(0, cap - 1)], zero)
    lo_v = torch.where(lo > 0, prefix[(lo - 1).clamp(0, cap - 1)], zero)
    return hi_v - lo_v


def _floor_log2(length: torch.Tensor, levels: int) -> torch.Tensor:
    """floor(log2(length)) for length >= 1, clipped to levels - 1, in
    integer compares (exact at every length)."""
    k = torch.zeros_like(length)
    for j in range(1, levels):
        k = k + (length >= (1 << j)).to(length.dtype)
    return k


class WindowExec(UnaryExecBase):
    def __init__(self, window_exprs: Sequence, spec: WindowSpec,
                 child: TpuExec):
        """window_exprs: (WindowFunction, name) pairs or WindowFunctions."""
        super().__init__(child)
        self.spec = spec
        child_schema = child.output_schema()
        self._child_schema = child_schema
        named = _named(window_exprs)
        self.fns = [fn for fn, _ in named]
        self._bound_parts = [e.bind(child_schema)
                             for e in spec.partition_by]
        self._bound_order = [
            SortOrder(o.expr.bind(child_schema), o.ascending,
                      o.nulls_first) for o in spec.order_by]
        self._bound_inputs = [
            fn.child.bind(child_schema) if fn.child is not None else None
            for fn in self.fns]
        fields = list(child_schema.fields) + [
            T.Field(n, _result_type(fn, child_schema)) for fn, n in named]
        self._schema = T.Schema(tuple(fields))
        self._hash_parts_disabled = False

    def output_schema(self) -> T.Schema:
        return self._schema

    def children_coalesce_goal(self) -> list[Optional[CoalesceGoal]]:
        return [RequireSingleBatch()]

    def describe(self):
        return (f"WindowExec([{', '.join(f.kind for f in self.fns)}], "
                f"partitionBy={len(self.spec.partition_by)})")

    # -- the hash lane -------------------------------------------------------
    def _use_hash_partitions(self, batch: ColumnarBatch) -> bool:
        """Wide PARTITION BY key sets (a string key is one 9-bit sort key
        per char position) sort by two murmur3 words instead: the order
        of the partitions is not observable in window results, only the
        grouping and the ORDER BY within it."""
        if not self._bound_parts or CK.is_retrying() or \
                self._hash_parts_disabled:
            return False
        if not C.get_active_conf()[C.HASH_GROUPING_ENABLED]:
            return False
        return wide_key_set(self._bound_parts, batch, self._child_schema)

    def _disable_hash_partitions(self) -> None:
        self._hash_parts_disabled = True

    # -- one batch ---------------------------------------------------------
    @kp_site("window")
    def window_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The window functions over one whole (dense) batch: the child's
        columns and one column per function, in the input row order."""
        use_hash = self._use_hash_partitions(batch)
        cap = batch.capacity
        frame = self.spec.frame
        ctx = make_eval_context(batch.columns, cap, batch.num_rows_i32)
        dev = ctx.device
        parts = [e.eval(ctx) for e in self._bound_parts]
        orders = [o.expr.eval(ctx) for o in self._bound_order]
        okeys = [(o, so.ascending, so.resolved_nulls_first)
                 for o, so in zip(orders, self._bound_order)]
        collision = None
        if use_hash:
            perm, sorted_mask, pbounds, obounds_all, collision = \
                hash_prefix_sort_bounds(parts, okeys, ctx.row_mask)
        else:
            keyspec = [(p, True, True) for p in parts] + okeys
            perm, sorted_mask, pbounds, obounds_all = \
                sort_with_prefix_bounds(keyspec, ctx.row_mask, len(parts))
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        bounds = pbounds if parts else (pos == 0) & sorted_mask
        seg = torch.cumsum(bounds.to(torch.int64), 0) - 1
        seg = torch.where(sorted_mask, seg, cap)
        seg_c = seg.clamp(0, cap - 1)
        seg_start_idx = masked_positions(bounds, cap, cap - 1)
        seg_start = seg_start_idx[seg_c]
        # a segment ends where the next starts; the last one at num_rows
        # (rows are partition-sorted with the invalid rows last)
        num_segs = bounds.sum()
        nxt = torch.cat([seg_start_idx[1:],
                         torch.full((1,), cap, dtype=torch.int64,
                                    device=dev)])
        seg_end_by_id = torch.where(
            pos >= num_segs - 1, batch.num_rows_i32.to(torch.int64), nxt)
        seg_end = seg_end_by_id[seg_c]  # exclusive
        obounds = obounds_all if orders else bounds

        # the frame [lo, hi) of every row, shared by all functions
        if frame.is_rows:
            lo = seg_start if frame.lower is None else torch.maximum(
                pos + max(frame.lower, -cap - 1), seg_start)
            hi = seg_end if frame.upper is None else torch.minimum(
                pos + min(frame.upper, cap) + 1, seg_end)
        else:
            # RANGE frame: one integral/date/timestamp order key
            assert len(orders) == 1, "range frames need exactly one order key"
            ovals = orders[0].gather(perm, sorted_mask).data.to(torch.int64)
            seg_q = torch.where(sorted_mask, seg, cap)
            if frame.lower is None:
                lo = seg_start
            else:
                lo = torch.maximum(_lex_searchsorted(
                    seg_q, ovals, seg_q, _sat_add(ovals, frame.lower),
                    "left", cap), seg_start)
            if frame.upper is None:
                hi = seg_end
            else:
                hi = torch.minimum(_lex_searchsorted(
                    seg_q, ovals, seg_q, _sat_add(ovals, frame.upper),
                    "right", cap), seg_end)
        hi = torch.maximum(hi, lo)

        results = []
        for fn, bin_ in zip(self.fns, self._bound_inputs):
            sv = None if bin_ is None else \
                bin_.eval(ctx).gather(perm, sorted_mask)
            results.append(self._eval_fn(
                fn, sv, pos, seg_start, seg_end, obounds, sorted_mask, cap,
                lo, hi))
        # back to the input row order: perm is a permutation of [0, cap)
        inv = torch.empty_like(perm)
        inv[perm] = pos
        out = [r.gather(inv, ctx.row_mask) for r in results]
        checks = CK.register_deopt(
            collision, f"hashWindowParts[exec {self.exec_id}]",
            self._disable_hash_partitions, batch.checks)
        return ColumnarBatch(self._schema, list(batch.columns) + out,
                             batch._rows, checks)

    def _eval_fn(self, fn, sv, pos, seg_start, seg_end, obounds,
                 sorted_mask, cap, lo, hi) -> ColumnVector:
        k = fn.kind
        if k == "row_number":
            return ColumnVector(T.INT32, (pos - seg_start + 1).to(
                torch.int32), sorted_mask)
        if k in ("rank", "dense_rank"):
            # dense: the order changes within the segment up to the row
            cum_o = torch.cumsum(obounds.to(torch.int64), 0)
            if k == "dense_rank":
                dense = cum_o - cum_o[seg_start] + 1
                return ColumnVector(T.INT32, dense.to(torch.int32),
                                    sorted_mask)
            # rank: the position of the first row of the tie group
            grp_first = masked_positions(obounds, cap, cap - 1)
            tie_start = grp_first[(cum_o - 1).clamp(0, cap - 1)]
            return ColumnVector(T.INT32, (tie_start - seg_start + 1).to(
                torch.int32), sorted_mask)
        if k in ("lead", "lag"):
            src = pos + (fn.offset if k == "lead" else -fn.offset)
            in_seg = (src >= seg_start) & (src < seg_end)
            got = sv.gather(src.clamp(0, cap - 1), in_seg & sorted_mask)
            if fn.default is not None:
                from spark_rapids_tpu_torch.exprs.base import Literal
                from spark_rapids_tpu_torch.exprs.conditional import _select
                dctx = make_eval_context([], cap, cap, sorted_mask)
                got = _select(in_seg, got,
                              Literal.of(fn.default).eval(dctx))
                got.validity = torch.where(in_seg, got.validity,
                                           sorted_mask)
            return got

        # frame aggregates ------------------------------------------------
        ok = sv.validity & sorted_mask
        cnt = _range_sum(torch.cumsum(ok.to(torch.int64), 0), lo, hi)
        if k == "count":
            return ColumnVector(T.INT64, cnt, sorted_mask)
        if k in ("sum", "avg"):
            acc = torch.float64 if (sv.dtype.is_floating or k == "avg") \
                else torch.int64
            vals = torch.where(ok, sv.data.to(acc), torch.zeros(
                (), dtype=acc, device=ok.device))
            s = _range_sum(torch.cumsum(vals, 0), lo, hi)
            if k == "sum":
                dt = T.FLOAT64 if sv.dtype.is_floating else T.INT64
                return ColumnVector(dt, s.to(dt.torch_dtype),
                                    sorted_mask & (cnt > 0))
            avg = s / torch.where(cnt > 0, cnt, 1).to(torch.float64)
            return ColumnVector(T.FLOAT64, avg, sorted_mask & (cnt > 0))
        if k in ("min", "max"):
            return self._minmax_frame(sv, ok, lo, hi, cap, k == "min",
                                      sorted_mask, cnt)
        if k in ("first", "last"):
            idx = lo if k == "first" else hi - 1
            return sv.gather(idx.clamp(0, cap - 1), sorted_mask & (hi > lo))
        raise ValueError(f"unsupported window function {k}")

    @staticmethod
    def _minmax_frame(sv, ok, lo, hi, cap, is_min, sorted_mask, cnt):
        """Sliding min/max from a sparse table: level j holds the min
        (max) of the 2^j rows from each row on; a frame of length L reads
        level floor(log2 L) at its two ends."""
        if sv.dtype.is_string:
            raise NotImplementedError("string window min/max")
        if sv.dtype.is_floating:
            fill = float("inf") if is_min else float("-inf")
            vals = sv.data.to(torch.float64)
        else:
            info = torch.iinfo(torch.int64)
            fill = info.max if is_min else info.min
            vals = sv.data.to(torch.int64)
        fill_t = torch.full((), fill, dtype=vals.dtype, device=vals.device)
        vals = torch.where(ok, vals, fill_t)
        op = torch.minimum if is_min else torch.maximum
        levels = [vals]
        span = 1
        while span < cap:
            prev = levels[-1]
            shifted = torch.cat([prev[span:], fill_t.expand(span)])
            levels.append(op(prev, shifted))
            span *= 2
        stacked = torch.stack(levels)  # [levels, cap]
        kk = _floor_log2(torch.clamp(hi - lo, min=1), len(levels))
        a = stacked[kk, lo.clamp(0, cap - 1)]
        b = stacked[kk, (hi - (torch.ones_like(kk) << kk)).clamp(
            0, cap - 1)]
        return ColumnVector(sv.dtype, op(a, b).to(sv.dtype.torch_dtype),
                            sorted_mask & (hi > lo) & (cnt > 0))

    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.exec.coalesce import coalesce_iterator
        for batch in coalesce_iterator(batches, RequireSingleBatch(),
                                       self._child_schema, self.device()):
            # frames read the WHOLE partition group, and a row split
            # would cut one mid-frame: pressure takes the no-split lane
            (out,) = tuple(self.oom_retry_batches(
                batch.dense(), self.window_batch, split=False,
                label=self.name()))
            self.update_output_metrics(out)
            yield out


# ---------------------------------------------------------------------------
class CpuWindow(CpuNode):
    """CPU plan node: the child's columns and one column per window
    function.  The planner converts it to WindowExec; tagged off the
    device it evaluates in pandas (`_cpu_window_eval`)."""

    def __init__(self, window_exprs: Sequence, spec: WindowSpec, child):
        super().__init__(child)
        self.spec = spec
        self.window_exprs = _named(window_exprs)
        cs = child.output_schema()
        fields = list(cs.fields) + [
            T.Field(n, _result_type(fn, cs)) for fn, n in self.window_exprs]
        self._schema = T.Schema(tuple(fields))

    def output_schema(self):
        return self._schema

    def output_partition_count(self) -> int:
        return 1

    def describe(self) -> str:
        kinds = ", ".join(f.kind for f, _ in self.window_exprs)
        return (f"CpuWindow([{kinds}], "
                f"partitionBy={len(self.spec.partition_by)})")

    def execute(self):
        import pandas as pd
        from spark_rapids_tpu_torch.plan.nodes import empty_df, normalize_df
        parts = [df for it in self.child.execute() for df in it]
        cs = self.child.output_schema()
        df = (pd.concat(parts, ignore_index=True) if parts
              else empty_df(cs))
        out = _cpu_window_eval(df, cs, self.spec, self.window_exprs)
        return [iter([normalize_df(out, self._schema)])]


def _nulls(s) -> np.ndarray:
    """True where a value is null; NaN counts as null, as `pd.isna` of a
    single value reads it."""
    import pandas as pd
    return np.asarray(pd.isna(s.to_numpy(dtype=object)), bool)


def _dense_codes(s, ascending: bool, null: np.ndarray) -> np.ndarray:
    """int64 codes whose order is the values' ascending (or descending)
    order; equal values share a code, nulls get 0.  Strings compare by
    code point, which is their UTF-8 byte order."""
    import pandas as pd
    codes = np.zeros(len(s), np.int64)
    if (~null).any():
        vals = s.to_numpy(dtype=object)[~null]
        got, _ = pd.factorize(vals, sort=True)
        codes[~null] = got if ascending else -got
    return codes


def _starts(flags: np.ndarray) -> np.ndarray:
    """For each row, the index of the last row at or before it whose flag
    is set (flags[0] must be set)."""
    pos = np.arange(len(flags))
    return np.maximum.accumulate(np.where(flags, pos, 0))


def _ends(flags: np.ndarray) -> np.ndarray:
    """For each row, one past the last row of its run (runs start where
    flags is set)."""
    n = len(flags)
    run = np.cumsum(flags) - 1
    first = np.flatnonzero(flags)
    nxt = np.append(first[1:], n)
    return nxt[run]


def _cpu_window_eval(df, child_schema, spec: WindowSpec, window_exprs):
    """The window semantics in pandas and numpy: the rows sort stably by
    (partition, order keys), each function evaluates over the sorted
    layout, and the results go back to the input order.  Running and
    whole-partition sums are sequential per partition (a grouped
    cumsum); a RANGE frame's CURRENT ROW includes its peers, as in
    Spark.  Frames other than UNBOUNDED/CURRENT and string min/max take
    a per-row loop."""
    import pandas as pd
    from spark_rapids_tpu_torch.plan.cpu_eval import cpu_eval, nullable_dtype

    n = len(df)
    out = df.copy()
    if n == 0:
        for fn, name in window_exprs:
            out[name] = pd.Series(
                [], dtype=nullable_dtype(_result_type(fn, child_schema)))
        return out
    df = df.reset_index(drop=True)
    pcols = [cpu_eval(e, df, child_schema).reset_index(drop=True)
             for e in spec.partition_by]
    if pcols:
        # one group per distinct key tuple; nulls (and NaN) are one key
        keys = pd.DataFrame({i: pd.Series(c.to_numpy(dtype=object)).where(
            ~_nulls(c), None) for i, c in enumerate(pcols)})
        gid = keys.groupby(list(range(len(pcols))), dropna=False,
                           sort=False).ngroup().to_numpy()
    else:
        gid = np.zeros(n, np.int64)
    okeys = []
    for o in spec.order_by:
        s = cpu_eval(o.expr, df, child_schema).reset_index(drop=True)
        null = _nulls(s)
        # null ordering first, then the value in its direction
        okeys.append(((null != o.resolved_nulls_first).astype(np.int64),
                      _dense_codes(s, o.ascending, null)))
    lex = [np.arange(n)]
    for null_rank, code in reversed(okeys):
        lex += [code, null_rank]
    order = np.lexsort(lex + [gid])
    pos = np.arange(n)
    g_s = gid[order]
    new_seg = np.r_[True, g_s[1:] != g_s[:-1]]
    new_peer = new_seg.copy()
    for null_rank, code in okeys:
        for k in (null_rank[order], code[order]):
            new_peer[1:] |= k[1:] != k[:-1]
    seg_id = np.cumsum(new_seg) - 1
    seg_start, seg_end = _starts(new_seg), _ends(new_seg)
    peer_id = np.cumsum(new_peer) - 1
    peer_start, peer_end = _starts(new_peer), _ends(new_peer)

    frame = spec.frame
    if frame.is_rows:
        lo = seg_start if frame.lower is None else \
            np.maximum(seg_start, pos + frame.lower)
        hi = seg_end if frame.upper is None else \
            np.minimum(seg_end, pos + frame.upper + 1)
    else:
        lo = {None: seg_start, 0: peer_start}.get(frame.lower)
        hi = {None: seg_end, 0: peer_end}.get(frame.upper)
    running = lo is not None and hi is not None and np.array_equal(
        lo, seg_start)

    for fn, name in window_exprs:
        rdt = _result_type(fn, child_schema)
        vals = null = None
        if fn.child is not None:
            s = cpu_eval(fn.child, df, child_schema).reset_index(drop=True)
            vals = s.to_numpy(dtype=object)[order]
            null = _nulls(s)[order]
        kind = fn.kind
        if kind == "row_number":
            res = pos - seg_start + 1
        elif kind == "rank":
            res = peer_start - seg_start + 1
        elif kind == "dense_rank":
            res = peer_id - peer_id[seg_start] + 1
        elif kind in ("lead", "lag"):
            src = pos + (fn.offset if kind == "lead" else -fn.offset)
            inside = (src >= seg_start) & (src < seg_end)
            res = np.full(n, fn.default, dtype=object)
            got = vals[np.clip(src, 0, n - 1)]
            gnull = null[np.clip(src, 0, n - 1)]
            res[inside] = np.where(gnull[inside], None, got[inside])
        elif lo is None or hi is None or (
                kind in ("min", "max") and (rdt.is_string or not running)):
            res = _loop_frames(kind, frame, vals, null, pos, seg_start,
                               seg_end, peer_start, peer_end)
        else:
            res = _vector_frames(kind, rdt, vals, null, seg_id, lo, hi)
        res_orig = np.empty(n, dtype=object)
        res_orig[order] = np.asarray(res, dtype=object)
        out[name] = pd.Series(res_orig, index=out.index).astype(
            nullable_dtype(rdt))
    return out


def _vector_frames(kind, rdt, vals, null, seg_id, lo, hi) -> np.ndarray:
    """count/sum/avg/first/last over [lo, hi) per row, and min/max over
    running frames (lo at the segment start), from per-segment
    sequential prefixes."""
    import pandas as pd
    n = len(vals)
    empty = hi <= lo
    cnt_p = pd.Series((~null).astype(np.int64)).groupby(seg_id).cumsum() \
        .to_numpy()

    def at(prefix, i, start_at_zero):
        # prefix value just before row i within its segment
        return np.where(start_at_zero, 0, prefix[np.clip(i - 1, 0, n - 1)])

    seg_first = np.r_[True, seg_id[1:] != seg_id[:-1]]
    lo_first = seg_first[np.clip(lo, 0, n - 1)] | empty
    cnt = cnt_p[np.clip(hi - 1, 0, n - 1)] - at(cnt_p, lo, lo_first)
    cnt = np.where(empty, 0, cnt)
    res = np.empty(n, dtype=object)
    if kind == "count":
        res[:] = cnt
        return res
    if kind in ("first", "last"):
        idx = np.clip(lo if kind == "first" else hi - 1, 0, n - 1)
        res[:] = np.where(null[idx] | empty, None, vals[idx])
        return res
    floating = kind == "avg" or rdt.is_floating
    x = np.where(null, 0, vals).astype(np.float64 if floating else np.int64)
    if kind in ("sum", "avg"):
        p = pd.Series(x).groupby(seg_id).cumsum().to_numpy()
        s = p[np.clip(hi - 1, 0, n - 1)] - at(p, lo, lo_first)
        if kind == "avg":
            s = s / np.maximum(cnt, 1)
        res[:] = np.where(cnt > 0, s, None)
        return res
    # running min/max (lo is the segment start)
    fill = (np.inf if kind == "min" else -np.inf) if floating else (
        np.iinfo(np.int64).max if kind == "min" else np.iinfo(np.int64).min)
    g = pd.Series(np.where(null, fill, x)).groupby(seg_id)
    run = (g.cummin() if kind == "min" else g.cummax()).to_numpy()
    res[:] = np.where(cnt > 0, run[np.clip(hi - 1, 0, n - 1)], None)
    return res


def _loop_frames(kind, frame, vals, null, pos, seg_start, seg_end,
                 peer_start, peer_end) -> list:
    """Any frame aggregate, row by row (offset frames, string min/max)."""
    out = []
    for i in range(len(vals)):
        s, e = seg_start[i], seg_end[i]
        if frame.is_rows:
            lo = s if frame.lower is None else max(s, i + frame.lower)
            hi = e if frame.upper is None else min(e, i + frame.upper + 1)
        else:
            if frame.lower not in (None, 0) or frame.upper not in (None, 0):
                raise NotImplementedError(
                    "CPU range frames support UNBOUNDED/CURRENT bounds")
            lo = s if frame.lower is None else peer_start[i]
            hi = e if frame.upper is None else peer_end[i]
        out.append(_frame_agg(kind, [None if null[j] else vals[j]
                                     for j in range(lo, hi)]))
    return out


def _frame_agg(kind: str, window: list):
    """`window` holds the frame's values, None for nulls: first/last keep
    Spark's ignoreNulls=false (a null boundary row gives null), the
    others skip nulls like their aggregate counterparts."""
    if kind == "first":
        return window[0] if window else None
    if kind == "last":
        return window[-1] if window else None
    vals = [v for v in window if v is not None]
    if kind == "count":
        return len(vals)
    if not vals:
        return None
    if kind == "sum":
        return sum(vals)
    if kind == "min":
        return min(vals)
    if kind == "max":
        return max(vals)
    if kind == "avg":
        return sum(vals) / len(vals)
    raise NotImplementedError(f"window agg {kind}")
