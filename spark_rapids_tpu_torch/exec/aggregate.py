"""Hash aggregation (port of spark_rapids_tpu/exec/aggregate.py).

Same two-phase shape as the reference: every input batch becomes a
partial batch of groups, the partials are concatenated and merged by an
internal FINAL-mode exec, and the evaluate step turns intermediates into
results.  Without group keys the reduction path skips grouping: each
batch reduces to one row, and the rows merge.  Three lanes group a batch:

  - dictionary lane (integral keys whose runtime range fits the
    dictGroupby budget): key-window slots and ONE grouped_sum kernel
    launch, no sort;
  - banded lane (Sum/Count/Average after the grouping sort): every measure
    accumulates per group in ONE window_group_sums kernel launch;
  - sort lane: segmented scans over the sorted rows, exact.

The grouping sort of the last two is lexicographic over the encoded
keys, or, for key sets wider than HASH_GROUP_MIN_WORDS packed words
(string keys take one 9-bit slice per character), a sort by two murmur3
words whose rare 64-bit collisions are detected exactly and deopt.

The first two lanes accumulate in f32 and are optimistic: float measures
need variableFloatAgg, and integral measures carry a deferred exactness
certificate.  When a certificate (or the dictionary window, or the hash
collision check) fails, `collect()` disables the lane at fault and
re-runs the query, so results are exact or the lane deopts.

A fused `pre_stage` (plan/fusion.py ComposedStage) evaluates a
Project/Filter chain inside every update lane before grouping: batches
arrive in the raw child schema, and group and input expressions bind
against the stage's output schema.

Every grouping, merge and evaluation goes through the OOM retry harness
(`TpuExec.oom_retry_batches`), and partial state that outgrows the device
window spills to the host and disk tiers and re-merges
(memory/oocore.py), as in the reference.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches,
                                                   empty_batch)
from spark_rapids_tpu_torch.columnar.vector import (MIN_CAPACITY,
                                                    ColumnVector,
                                                    bucket_capacity,
                                                    gather_columns_grouped)
from spark_rapids_tpu_torch.exec.base import (SchemaOnlyExec, TpuExec,
                                              UnaryExecBase, kp_site,
                                              make_eval_context)
from spark_rapids_tpu_torch.exprs.aggregates import (AggAlias, AggContext,
                                                     run_agg_phase)
from spark_rapids_tpu_torch.exprs.base import Expression, output_name
from spark_rapids_tpu_torch.memory import oocore as OC
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.ops.grouped_window import window_group_sums
from spark_rapids_tpu_torch.ops.kernels import grouped_sum
from spark_rapids_tpu_torch.ops.sort_encode import (
    HASH_GROUP_MIN_WORDS, hash_sort_bounds, masked_positions,
    sort_with_bounds, wide_key_set)
from spark_rapids_tpu_torch.utils import checks as CK
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import profile as P

log = logging.getLogger(__name__)

_I64_MAX = torch.iinfo(torch.int64).max
_F32 = torch.float32
_I64 = torch.int64


class AggMode(enum.Enum):
    PARTIAL = "partial"
    FINAL = "final"
    COMPLETE = "complete"


def _to_alias(a, i: int) -> AggAlias:
    return a if isinstance(a, AggAlias) else AggAlias(a, f"agg{i}")


class HashAggregateExec(UnaryExecBase):
    #: cap bound for the banded lane: first-row indices travel as two
    #: 11-bit f32 limbs (exact one-hot sums), covering rows < 2^22
    BANDED_MAX_CAP = 1 << 22
    #: per-batch overflow rows the dictionary lane carries inline as
    #: singleton partial groups before its deferred check fires
    DICT_OVERFLOW_BUDGET = 1024
    #: optimistic group width of sort-lane outputs; on overflow it
    #: escalates x4 per deopt-and-retry round, learned per exec
    COMPACT_GROUPS_CAP = 1 << 14
    COMPACT_GROUPS_MAX = 1 << 20

    def __init__(self, group_exprs: Sequence[Expression],
                 aggregates: Sequence, child: TpuExec,
                 mode: AggMode = AggMode.COMPLETE, pre_stage=None):
        if pre_stage is not None and mode == AggMode.FINAL:
            raise ValueError("a fused pre_stage feeds update lanes only")
        super().__init__(child)
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.aggregates = [_to_alias(a, i) for i, a in enumerate(aggregates)]
        self._pre_stage = pre_stage
        self._fused_event_done = False
        child_schema = (pre_stage.schema if pre_stage is not None
                        else child.output_schema())
        self._child_schema = child_schema
        self._bound_groups = [e.bind(child_schema) for e in self.group_exprs]
        self._group_fields = tuple(
            T.Field(output_name(e, i), b.data_type(child_schema))
            for i, (e, b) in enumerate(
                zip(self.group_exprs, self._bound_groups)))

        self._funcs = [a.func for a in self.aggregates]
        self._inter_offsets = []
        if mode == AggMode.FINAL:
            # child emits keys + intermediates; resolve types positionally
            off = len(self._group_fields)
            self._inter_types = []
            for f in self._funcs:
                n = f.num_intermediates
                self._inter_offsets.append((off, off + n))
                self._inter_types.append(tuple(
                    child_schema.fields[i].dtype for i in range(off, off + n)))
                off += n
        else:
            self._bound_inputs = [
                [e.bind(child_schema) for e in f.input_exprs()]
                for f in self._funcs]
            self._inter_types = [tuple(f.intermediate_types(child_schema))
                                 for f in self._funcs]
            off = len(self._group_fields)
            for ts in self._inter_types:
                self._inter_offsets.append((off, off + len(ts)))
                off += len(ts)

        fields = list(self._group_fields)
        if mode == AggMode.PARTIAL:
            for a, ts in zip(self.aggregates, self._inter_types):
                for j, it in enumerate(ts):
                    fields.append(T.Field(f"{a.name}#{j}", it))
        elif mode == AggMode.FINAL:
            for a, ts in zip(self.aggregates, self._inter_types):
                fields.append(
                    T.Field(a.name, a.func.result_from_intermediates(ts)))
        else:
            for a in self.aggregates:
                fields.append(T.Field(a.name,
                                      a.func.result_type(child_schema)))
        self._schema = T.Schema(tuple(fields))
        self._dict_qual = self._dict_plan()
        self._dict_range_misses = 0
        #: padded dictionary width (int for one key, tuple of per-key pads
        #: for several), sized by a first-batch range probe
        self._dict_gpad = None
        self._banded_qual = all(type(f).__name__ in ("Sum", "Count",
                                                     "Average")
                                for f in self._funcs)
        self._banded_disabled = False
        self._hash_group_disabled = False
        self._compact_cap = self.COMPACT_GROUPS_CAP
        self._merge_exec: Optional["HashAggregateExec"] = None

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        keys = ", ".join(f.name for f in self._group_fields)
        aggs = ", ".join(a.name for a in self.aggregates)
        fused = "" if self._pre_stage is None else \
            f", fused=[{self._pre_stage.describe_ops()}]"
        return (f"HashAggregateExec(mode={self.mode.value}, "
                f"keys=[{keys}], aggs=[{aggs}]{fused})")

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        if self._pre_stage is not None:
            # EXPLAIN prints the fusion group's member operators
            for m in self._pre_stage.members:
                s += "\n" + "  " * (indent + 1) + "* " + m.describe()
        for c in self._children:
            s += "\n" + c.tree_string(indent + 1)
        return s

    @property
    def fused_members(self) -> list:
        """(describe, MetricSet) per fused member op, for the
        EXPLAIN-with-metrics breakdown; empty when unfused."""
        if self._pre_stage is None:
            return []
        return [(m.describe(), m.metrics) for m in self._pre_stage.members]

    def _kp_members(self) -> Optional[list]:
        """The fused pre-stage's member names, which the kernel table
        attributes to this exec's update-lane steps too."""
        return (self._pre_stage.member_names()
                if self._pre_stage is not None else None)

    def _make_ctx(self, batch: ColumnarBatch):
        """Update-lane evaluation context: with a fused pre-stage the raw
        child columns first flow through the composed project/filter
        DAG."""
        ctx = make_eval_context(batch.columns, batch.capacity,
                                batch.num_rows_i32, batch.sparse)
        if self._pre_stage is not None:
            from spark_rapids_tpu_torch.plan import fusion as FZ
            ctx = FZ.eval_stage_ctx(self._pre_stage, ctx)
        return ctx

    # -- lane selection -----------------------------------------------------
    def _use_hash_grouping(self, batch: ColumnarBatch) -> bool:
        # the last deopt retry must be guaranteed-valid: lexicographic
        if self._hash_group_disabled or CK.is_retrying():
            return False
        if not C.get_active_conf()[C.HASH_GROUPING_ENABLED]:
            return False
        # with a fused pre-stage the batch holds the RAW child columns,
        # so routing reads dtypes only
        return wide_key_set(self._bound_groups,
                            None if self._pre_stage is not None else batch,
                            self._child_schema, HASH_GROUP_MIN_WORDS)

    def _disable_hash_grouping(self) -> None:
        # a 64-bit murmur3 collision between two distinct key tuples
        # deopts this exec to the lexicographic lane for good
        self._hash_group_disabled = True

    def _register_collision_check(self, collision, checks: tuple) -> tuple:
        return CK.register_deopt(collision,
                                 f"hashGroupby[exec {self.exec_id}]",
                                 self._disable_hash_grouping, checks)

    def _banded_float_measures(self, phase: str) -> bool:
        """True when this phase would put FLOATING values through the f32
        banded accumulator."""
        if phase == "merge":
            return any(t.is_floating for ts in self._inter_types
                       for t in ts)
        return any(e.data_type(self._child_schema).is_floating
                   for bins in self._bound_inputs for e in bins)

    def _use_banded(self, batch: ColumnarBatch, phase: str) -> bool:
        if not self._banded_qual or self._banded_disabled:
            return False
        if CK.is_retrying():
            return False  # the last retry must be guaranteed-valid
        conf = C.get_active_conf()
        if not conf[C.BANDED_GROUPBY_ENABLED]:
            return False
        cap = batch.capacity
        if cap % 128 or cap > self.BANDED_MAX_CAP:
            return False
        return not (self._banded_float_measures(phase)
                    and not conf[C.VARIABLE_FLOAT_AGG])

    def _disable_banded(self) -> None:
        self._banded_disabled = True
        if self._merge_exec is not None:
            self._merge_exec._banded_disabled = True

    def _register_banded_check(self, cert, checks: tuple) -> tuple:
        return CK.register_deopt(cert,
                                 f"bandedGroupby[exec {self.exec_id}]",
                                 self._disable_banded, checks)

    def _kernel_compact_cap(self, batch: ColumnarBatch) -> Optional[int]:
        """Compact group width for the sort lane's output, or None (full
        width).  The last deopt retry always runs uncompacted."""
        if CK.is_retrying():
            return None
        tc = self._compact_cap
        if tc > self.COMPACT_GROUPS_MAX or batch.capacity <= tc:
            return None
        return tc

    def _escalate_compact(self, failed_cap: int) -> None:
        # one escalation per retry round: several batches' checks may fail
        # together, and each invokes recover
        if self._compact_cap == failed_cap:
            self._compact_cap = failed_cap * 4

    def _register_excess_check(self, excess, wcap: Optional[int],
                               checks: tuple) -> tuple:
        if excess is None:
            return checks
        chk = CK.register(CK.BatchCheck(
            excess, origin=f"aggCompactGroups[exec {self.exec_id}]",
            recover=lambda cap=wcap: self._escalate_compact(cap)))
        return checks + (chk,)

    # -- sort lane and banded lane -------------------------------------------
    @kp_site(lambda batch, phase, *a: f"agg-{phase}")
    def _groupby_sorted(self, batch: ColumnarBatch, phase: str,
                        wcap: Optional[int]):
        """phase: 'update' (raw inputs) or 'merge' (intermediates).
        `wcap`: compact group width; the group count past it is reported
        as a deferred excess flag.  Returns (columns, num_groups,
        collision flag or None, excess flag or None, banded certificate
        flag or None)."""
        use_hash = self._use_hash_grouping(batch)
        use_banded = self._use_banded(batch, phase)
        cap = batch.capacity
        out_cap = wcap if wcap is not None else cap
        ctx = (self._make_ctx(batch) if phase == "update" else
               make_eval_context(batch.columns, cap, batch.num_rows_i32,
                                 batch.sparse))
        dev = ctx.device
        keys = [e.eval(ctx) for e in self._bound_groups]
        key_cols = [(k, True, True) for k in keys]
        if use_hash:
            perm, sorted_valid, bounds, collision = hash_sort_bounds(
                key_cols, ctx.row_mask)
        else:
            perm, sorted_valid, bounds = sort_with_bounds(key_cols,
                                                          ctx.row_mask)
            collision = None
        seg_ids = torch.cumsum(bounds, 0, dtype=torch.int32) - 1
        num_groups = bounds.sum().to(torch.int32)
        excess = (num_groups > out_cap) if wcap is not None else None
        grp_valid = torch.arange(out_cap, device=dev) < num_groups

        if phase == "update":
            inputs_per_f = [[e.eval(ctx) for e in bins]
                            for bins in self._bound_inputs]
        else:
            inputs_per_f = [[ctx.columns[i] for i in range(lo, hi)]
                            for lo, hi in self._inter_offsets]
        flat = [v for ins in inputs_per_f for v in ins]
        it = iter(gather_columns_grouped(flat, perm, sorted_valid))
        sorted_per_f = [[next(it) for _ in ins] for ins in inputs_per_f]

        if use_banded:
            out_cols, first_idx, cert = self._banded_aggregate(
                phase, sorted_per_f, sorted_valid, bounds, seg_ids,
                grp_valid, cap, out_cap)
            rep_idx = perm[first_idx.to(_I64)]
            out_keys = [k.gather(rep_idx, grp_valid) for k in keys]
            return out_keys + out_cols, num_groups, collision, excess, cert

        # group key representatives: first row of each segment
        first_idx = masked_positions(bounds, out_cap, fill_value=cap - 1)
        # per-segment LAST sorted row: one before the next segment's
        # start; the last real segment (which also absorbs trailing
        # invalid rows' segment ids) ends at cap-1
        nxt = torch.cat([first_idx[1:],
                         torch.full((1,), cap, dtype=_I64, device=dev)])
        ends = torch.where(torch.arange(out_cap, device=dev)
                           >= num_groups - 1, cap - 1, nxt - 1)
        actx = AggContext(seg_ids, cap, sorted_valid, bounds, ends,
                          out_capacity=out_cap)
        rep_idx = perm[first_idx]
        out_cols = [k.gather(rep_idx, grp_valid) for k in keys]
        for outs in run_agg_phase(actx, self._funcs, sorted_per_f, phase):
            out_cols.extend(ColumnVector(o.dtype, o.data,
                                         o.validity & grp_valid, o.narrow,
                                         o.lengths)
                            for o in outs)
        return out_cols, num_groups, collision, excess, None

    def _banded_aggregate(self, phase, sorted_per_f, sorted_valid,
                          bounds, seg_ids, grp_valid, cap, out_cap):
        """Every Sum/Count/Average measure, plus two 11-bit first-row-index
        limbs for key recovery, accumulates per group in ONE
        window_group_sums launch.  Returns (agg columns, first_idx,
        cert_flag): cert_flag reports an integral measure whose f32
        accumulation may have rounded; the caller registers it as a
        deferred deopt."""
        measures: list = []
        specs: list = []
        cert_ids: list = []

        def add(arr) -> int:
            measures.append(arr.to(_F32))
            return len(measures) - 1

        def value_measure(p: ColumnVector, ok):
            """f32 measure of a column's values, zeroed where not ok;
            prefers the int32 narrow shadow of an integral column."""
            raw = p.narrow if (p.narrow is not None
                               and not p.dtype.is_floating) else p.data
            return torch.where(ok, raw.to(_F32), 0.0)

        rv = sorted_valid
        for f, ins, its in zip(self._funcs, sorted_per_f,
                               self._inter_types):
            nm = type(f).__name__
            if nm == "Count":
                if phase == "merge":
                    (p,) = ins
                    mi = add(value_measure(p, p.validity & rv))
                    cert_ids.append(mi)  # counts are nonnegative
                    specs.append(("count", mi, None))
                else:
                    ok = rv if f.child is None else ins[0].validity & rv
                    specs.append(("count", add(ok), None))
            elif nm == "Sum":
                (p,) = ins
                ok = p.validity & rv
                mi = add(value_measure(p, ok))
                fi = add(ok)
                if not its[0].is_floating:
                    cert_ids.append(add(measures[mi].abs()))
                specs.append(("sum", mi, fi))
            else:  # Average: intermediates (f64 sum, i64 count)
                if phase == "merge":
                    s_p, c_p = ins
                    ms = add(value_measure(s_p, rv))
                    mc = add(value_measure(c_p, rv))
                    cert_ids.append(mc)
                    specs.append(("avg", ms, mc))
                else:
                    (p,) = ins
                    ok = p.validity & rv
                    mi = add(value_measure(p, ok))
                    fi = add(ok)
                    if not p.dtype.is_floating:
                        cert_ids.append(add(measures[mi].abs()))
                    specs.append(("avg", mi, fi))

        isf32 = bounds.to(_F32)
        iota = torch.arange(cap, dtype=torch.int32, device=bounds.device)
        li = add((iota & 2047).to(_F32) * isf32)
        hi = add((iota >> 11).to(_F32) * isf32)

        sums = window_group_sums(seg_ids, measures, out_cap=out_cap,
                                 capacity=cap)

        def col(i):
            return sums[:, i]

        # exactly one first-row hit per group -> the limb sums are the
        # limb values themselves, exact in f32
        first_idx = (col(li) + col(hi) * 2048.0).to(torch.int32).clamp(
            0, cap - 1)
        cert = None
        if cert_ids:
            bad = torch.zeros((), dtype=torch.bool, device=bounds.device)
            for ci in cert_ids:
                bad = bad | (torch.where(grp_valid, col(ci), 0.0)
                             >= float(1 << 23)).any()
            cert = bad

        out_cols: list = []
        for (kind, mi, fi), its in zip(specs, self._inter_types):
            if kind == "count":
                c = torch.round(col(mi)).to(_I64)
                out_cols.append(ColumnVector(T.INT64, c, grp_valid))
            elif kind == "sum":
                has = (col(fi) > 0) & grp_valid
                dt = its[0]
                data = (col(mi).to(torch.float64) if dt.is_floating
                        else torch.round(col(mi)).to(_I64))
                out_cols.append(ColumnVector(dt, data, has))
            else:  # avg: (f64 sum, i64 count)
                out_cols.append(ColumnVector(
                    T.FLOAT64, col(mi).to(torch.float64), grp_valid))
                out_cols.append(ColumnVector(
                    T.INT64, torch.round(col(fi)).to(_I64), grp_valid))
        return out_cols, first_idx, cert

    @kp_site("agg-eval")
    def _evaluate_one(self, merged: ColumnarBatch) -> ColumnarBatch:
        """Final projection: intermediates -> results (no regrouping)."""
        out = list(merged.columns[:len(self._group_fields)])
        off = len(self._group_fields)
        for f in self._funcs:
            n = f.num_intermediates
            out.append(f.evaluate(merged.columns[off: off + n],
                                  self._child_schema))
            off += n
        return ColumnarBatch(self._schema, out, merged._rows,
                             merged.checks)

    # -- dictionary lane ----------------------------------------------------
    def _dict_plan(self):
        """Static qualification for the sort-free dictionary lane: 1..3
        integral keys (several keys fold into one composite slot id),
        Sum/Count/Average over float inputs (variableFloatAgg-gated f32
        accumulation) or integral inputs (exact-or-deopt through an
        f32-exactness certificate).  Returns (plan, measures) or None."""
        if self.mode == AggMode.FINAL or \
                not 1 <= len(self._bound_groups) <= 3:
            return None
        if not all(f.dtype.is_integral for f in self._group_fields):
            return None
        plan, measures = [], []
        self._dict_float = False
        for f, bins in zip(self._funcs, self._bound_inputs):
            name = type(f).__name__
            if name == "Count":
                if bins:
                    plan.append(("count_expr", len(measures)))
                    measures.append(("flag", bins[0]))
                else:
                    plan.append(("count_star", None))
            elif name in ("Sum", "Average"):
                dt = bins[0].data_type(self._child_schema)
                if dt.is_floating:
                    self._dict_float = True
                    plan.append((name.lower(), len(measures)))
                    measures.append(("val", bins[0]))
                    measures.append(("flag", bins[0]))
                elif dt.is_integral:
                    # f32 adds of integers are exact while every group's
                    # sum(|v|) stays under 2^24; the kernel accumulates
                    # that certificate alongside, and the deferred check
                    # deopts past 2^23
                    plan.append((name.lower() + "_int", len(measures)))
                    measures.append(("val", bins[0]))
                    measures.append(("flag", bins[0]))
                    measures.append(("absval", bins[0]))
                else:
                    return None
            else:
                return None
        return plan, measures

    def _dict_groupby_batch(self, batch: ColumnarBatch):
        """Sort-free grouped aggregation of one batch when the integral
        key ranges fit the dictionary budget: key-window slots, one
        grouped_sum launch and the partial-batch finalize.  A one-time
        first-batch probe sizes the padded dictionary; later batches
        anchor their window at their own device-side minimum and report
        overflow through a deferred check.  Returns the partial-layout
        batch or None (the caller takes the sort lane)."""
        conf = C.get_active_conf()
        if not conf[C.DICT_GROUPBY_ENABLED] or self._dict_qual is None:
            return None
        if self._dict_float and not conf[C.VARIABLE_FLOAT_AGG]:
            return None
        if batch.capacity >= (1 << 24) or batch.capacity % 128:
            return None  # f32 counts exact below 2^24
        if self._dict_range_misses >= 3:
            return None
        nk = len(self._bound_groups)
        if self._dict_gpad is None:
            spans = self._dict_probe(batch)
            budget = int(conf[C.DICT_GROUPBY_MAX_GROUPS])
            if nk == 1:
                if spans[0] > budget:
                    self._dict_range_misses += 1
                    return None
                self._dict_gpad = max(8, bucket_capacity(spans[0]))
            else:
                # per-key ~12.5% headroom (later batches drift); each key
                # also gets a null slot; the composite must fit the budget
                pads = [max(4, -(-(s + s // 8) // 4) * 4) for s in spans]
                total = 1
                for p in pads:
                    total *= p + 1
                if total > budget:
                    self._dict_range_misses += 1
                    return None
                self._dict_gpad = tuple(pads)
        if nk == 1:
            cols, n, excess = self._dict_fused(batch, self._dict_gpad)
        else:
            cols, n, excess = self._dict_fused_multi(batch,
                                                     list(self._dict_gpad))
        check = CK.register(CK.BatchCheck(
            excess, f"dictGroupby[exec {self.exec_id}]",
            self._disable_dict_path))
        return ColumnarBatch(self._partial_schema(), cols, n,
                             batch.checks + (check,))

    def _disable_dict_path(self) -> None:
        self._dict_range_misses = 1 << 20

    @kp_site("agg-dict-probe")
    def _dict_probe(self, batch: ColumnarBatch) -> list:
        """Per-key value spans of the first batch (one host readback)."""
        ctx = self._make_ctx(batch)
        i64 = torch.iinfo(_I64)
        mins, maxs = [], []
        for e in self._bound_groups:
            k = e.eval(ctx)
            ok = k.validity & ctx.row_mask
            kd = k.data.to(_I64)
            mins.append(torch.where(ok, kd, i64.max).min())
            maxs.append(torch.where(ok, kd, i64.min).max())
        CK.note_host_sync("agg.dict_probe", nbytes=16 * len(mins))
        lo_hi = torch.stack([torch.stack(mins), torch.stack(maxs)]).cpu()
        return [max(int(hi) - int(lo) + 1, 1) if hi >= lo else 1
                for lo, hi in zip(lo_hi[0].tolist(), lo_hi[1].tolist())]

    @staticmethod
    def _eval_dict_measures(ctx, measures, rows):
        """Evaluate measures into (f32 kernel inputs, raw (value, valid)
        pairs for overflow rows).  Raw values stay unmasked and uncast;
        mask and cast happen after the (tiny) overflow gather."""
        vals, raw = [], []
        for kind, e in measures:
            v = e.eval(ctx)
            good = v.validity & rows
            if kind in ("val", "absval"):
                v32 = (v.narrow if v.narrow is not None else v.data).to(_F32)
                if kind == "absval":
                    # certificate input only: overflow singletons read the
                    # paired "val" measure's raw entry
                    v32 = v32.abs()
                vals.append(torch.where(good, v32, 0.0))
                raw.append((None, good) if kind == "absval"
                           else (v.data, good))
            else:
                vals.append(good.to(_F32))
                raw.append((good, good))
        return vals, raw

    @staticmethod
    def _emit_dict_partials(plan, raw, sums_at, cnt_mixed, wi, oi,
                            from_win, valid_out):
        """Window groups + inline overflow singletons -> partial agg
        columns.  `sums_at(mi)` yields the compacted window column of
        kernel measure mi.  Invalid cells are masked AFTER the overflow
        gather, so they read as 0."""
        out = []
        inexact = torch.zeros((), dtype=torch.bool, device=wi.device)
        for kind, mi in plan:
            if kind == "count_star":
                out.append(ColumnVector(T.INT64, cnt_mixed, valid_out))
                continue
            if kind == "count_expr":
                win_c = torch.round(sums_at(mi)).to(_I64)
                _, good_o = raw[mi]
                out.append(ColumnVector(
                    T.INT64, torch.where(from_win, win_c[wi],
                                         good_o[oi].to(_I64)), valid_out))
                continue
            s_w = sums_at(mi)
            f_w = torch.round(sums_at(mi + 1)).to(_I64)
            val_o, good_o = raw[mi]
            some = torch.where(from_win, (f_w > 0)[wi],
                               good_o[oi]) & valid_out
            if kind in ("sum_int", "average_int"):
                # exactness certificate: every f32 add was exact iff the
                # group's sum(|v|) stayed under 2^24 (threshold 2^23
                # leaves margin for the certificate's own rounding)
                inexact = inexact | (sums_at(mi + 2) >= float(1 << 23)).any()
                win_s = torch.round(s_w).to(_I64)
                si = torch.where(some, torch.where(from_win, win_s[wi],
                                                   val_o[oi].to(_I64)), 0)
                if kind == "sum_int":
                    out.append(ColumnVector(T.INT64, si, some))
                else:  # average over ints: (f64 sum, i64 count)
                    out.append(ColumnVector(T.FLOAT64,
                                            si.to(torch.float64), some))
                    out.append(ColumnVector(
                        T.INT64, torch.where(from_win, f_w[wi],
                                             good_o[oi].to(_I64)),
                        valid_out))
                continue
            s = torch.where(some, torch.where(
                from_win, s_w[wi], val_o[oi].to(torch.float64)), 0.0)
            out.append(ColumnVector(T.FLOAT64, s, some))
            if kind == "average":
                out.append(ColumnVector(
                    T.INT64, torch.where(from_win, f_w[wi],
                                         good_o[oi].to(_I64)), valid_out))
        return out, inexact

    @kp_site("agg-dict-fused")
    def _dict_fused(self, batch: ColumnarBatch, g_pad: int):
        """Single-key dictionary lane: the key window (anchored at this
        batch's own device-side minimum), one grouped_sum launch, the
        compacted partial batch, and out-of-window rows folded in as
        inline singleton partial groups.  Slot layout: [0, g_pad) dense
        key window, g_pad = null group, g_pad+1 = masked (overflow and
        padding).  Returns (columns, num_rows, excess_flag), all on the
        device."""
        cap = batch.capacity
        plan, measures = self._dict_qual
        kdt = self._group_fields[0].dtype
        ovf_budget = min(self.DICT_OVERFLOW_BUDGET, cap)
        w_cap = g_pad + 1
        out_cap = bucket_capacity(w_cap + ovf_budget)
        ctx = self._make_ctx(batch)
        dev = ctx.device
        k = self._bound_groups[0].eval(ctx)
        ok = k.validity & ctx.row_mask
        kd = (k.narrow if k.narrow is not None else k.data).to(_I64)
        kmin = torch.where(ok, kd, _I64_MAX).min()
        off = kd - kmin
        in_win = ok & (off >= 0) & (off < g_pad)
        slots = torch.where(in_win, off, torch.where(
            ctx.row_mask & ~k.validity, g_pad, g_pad + 1)).to(torch.int32)
        ovf_mask = ok & ~in_win
        ovf_cnt = ovf_mask.sum().to(torch.int32)
        vals, raw = self._eval_dict_measures(ctx, measures, ctx.row_mask)
        # row masking rides the SLOT sentinel (padding and filtered rows
        # -> g_pad+1, never read back), so the kernel's prefix bound is
        # the full capacity — required for sparse inputs
        sums, counts = grouped_sum(slots, vals, cap, n_groups=g_pad + 1,
                                   capacity=cap)

        # window-group compaction: null group FIRST, then dense keys
        order = torch.cat([torch.full((1,), g_pad, dtype=_I64, device=dev),
                           torch.arange(g_pad, device=dev)])
        cnt_o = counts[order]
        sums_o = sums[order]
        occupied = cnt_o > 0
        n_win = occupied.sum().to(torch.int32)
        nz = masked_positions(occupied, w_cap, fill_value=0)
        slot_w = order[nz]
        cnt_w = cnt_o[nz]
        oidx = masked_positions(ovf_mask, ovf_budget, fill_value=cap - 1)
        n_out = n_win + ovf_cnt.clamp(max=ovf_budget)
        excess = ovf_cnt > ovf_budget

        i = torch.arange(out_cap, device=dev)
        valid_out = i < n_out
        from_win = i < n_win
        wi = i.clamp(0, w_cap - 1)
        oi = oidx[(i - n_win).clamp(0, ovf_budget - 1)]

        key_data = torch.where(from_win,
                               (kmin + slot_w).to(kdt.torch_dtype)[wi],
                               k.data[oi].to(kdt.torch_dtype))
        key_valid = torch.where(from_win, (slot_w != g_pad)[wi],
                                k.validity[oi]) & valid_out
        out = [ColumnVector(kdt, key_data, key_valid)]
        cnt_mixed = torch.where(from_win, cnt_w.to(_I64)[wi], 1)
        cols_m, inexact = self._emit_dict_partials(
            plan, raw, lambda mi: sums_o[:, mi][nz], cnt_mixed, wi, oi,
            from_win, valid_out)
        out.extend(cols_m)
        return out, n_out, excess | inexact

    @kp_site("agg-dict-fused-multi")
    def _dict_fused_multi(self, batch: ColumnarBatch, pads: list):
        """Composite-key variant of `_dict_fused`: each integral key gets
        a dense window of `pads[i]` value slots + 1 null slot, anchored at
        the batch's own per-key minimum; the per-key slots fold into ONE
        composite id (row-major strides) for the same grouped_sum launch.
        Rows outside ANY key's window become inline singleton partial
        groups."""
        cap = batch.capacity
        key_exprs = self._bound_groups
        kdts = [f.dtype for f in self._group_fields]
        plan, measures = self._dict_qual
        nk = len(key_exprs)
        widths = [p + 1 for p in pads]  # value slots + null slot
        strides = [1] * nk
        for j in range(nk - 2, -1, -1):
            strides[j] = strides[j + 1] * widths[j + 1]
        G = strides[0] * widths[0]
        ovf_budget = min(self.DICT_OVERFLOW_BUDGET, cap)
        w_cap = G
        out_cap = bucket_capacity(G + ovf_budget)
        ctx = self._make_ctx(batch)
        dev = ctx.device
        rows = ctx.row_mask
        combined = torch.zeros(cap, dtype=torch.int32, device=dev)
        in_win = rows
        kmins, ks = [], []
        for e, span, stride in zip(key_exprs, pads, strides):
            k = e.eval(ctx)
            ks.append(k)
            okk = k.validity & rows
            kd = (k.narrow if k.narrow is not None else k.data).to(_I64)
            kmin = torch.where(okk, kd, _I64_MAX).min()
            off64 = kd - kmin
            within = (off64 >= 0) & (off64 < span)
            off = off64.clamp(0, span - 1).to(torch.int32)
            # per-key slot: dense value slot, or the null slot
            slot_i = torch.where(k.validity, torch.where(within, off, 0),
                                 span)
            in_win = in_win & torch.where(k.validity, within, True)
            combined = combined + slot_i * stride
            kmins.append(kmin)
        ovf_mask = rows & ~in_win
        ovf_cnt = ovf_mask.sum().to(torch.int32)
        slots = torch.where(in_win, combined, G).to(torch.int32)
        vals, raw = self._eval_dict_measures(ctx, measures, rows)
        sums, counts = grouped_sum(slots, vals, cap, n_groups=G + 1,
                                   capacity=cap)
        occupied = counts[:G] > 0
        n_win = occupied.sum().to(torch.int32)
        nz = masked_positions(occupied, w_cap, fill_value=0)
        cnt_w = counts[:G][nz]
        oidx = masked_positions(ovf_mask, ovf_budget, fill_value=cap - 1)
        n_out = n_win + ovf_cnt.clamp(max=ovf_budget)
        excess = ovf_cnt > ovf_budget

        i = torch.arange(out_cap, device=dev)
        valid_out = i < n_out
        from_win = i < n_win
        wi = i.clamp(0, w_cap - 1)
        oi = oidx[(i - n_win).clamp(0, ovf_budget - 1)]

        out = []
        for ki in range(nk):
            comp = (nz // strides[ki]) % widths[ki]
            k = ks[ki]
            tdt = kdts[ki].torch_dtype
            key_data = torch.where(from_win, (kmins[ki] + comp).to(tdt)[wi],
                                   k.data[oi].to(tdt))
            key_valid = torch.where(from_win, (comp != pads[ki])[wi],
                                    k.validity[oi]) & valid_out
            out.append(ColumnVector(kdts[ki], key_data, key_valid))
        cnt_mixed = torch.where(from_win, cnt_w.to(_I64)[wi], 1)
        cols_m, inexact = self._emit_dict_partials(
            plan, raw, lambda mi: sums[:G, mi][nz], cnt_mixed, wi, oi,
            from_win, valid_out)
        out.extend(cols_m)
        return out, n_out, excess | inexact

    # -- execution ----------------------------------------------------------
    def process_partition(self, batches) -> Iterator[ColumnarBatch]:
        """Group every batch into partials (each through the OOM retry
        harness: a split piece's groups just add a partial), merge the
        partials, and evaluate.  Once the accounted estimate of the
        buffered partials says they cannot fit the device window
        (memory/oocore.py `should_go_external`), the partial state spills
        through the host→disk tiers in merged blocks and re-merges in
        window-sized groups (partial aggregation state is key-idempotent,
        so spilled blocks re-merge in any grouping)."""
        if not self.group_exprs:
            yield from self._reduction_path(batches)
            return
        conf = C.get_active_conf()
        partials: list[ColumnarBatch] = []
        pending_bytes = 0
        runs: list = []
        external = False
        run_target = max(1, OC.window_bytes(conf) // OC.MERGE_FAN_IN)

        def flush_state():
            nonlocal partials, pending_bytes
            if not partials:
                return
            merged = partials[0] if len(partials) == 1 else \
                self._merge_partials(partials)
            runs.append(OC.spill_run(merged.dense(), label=self.name(),
                                     metrics=self.metrics, conf=conf))
            partials = []
            pending_bytes = 0

        try:
            for batch in batches:
                if not batch.maybe_nonempty():
                    continue
                with self.metrics.timed(M.TOTAL_TIME):
                    pieces = list(self.oom_retry_batches(
                        batch, self._groupby_one,
                        label=f"{self.name()}.groupBatch"))
                partials.extend(pieces)
                pending_bytes += sum(R.estimate_batch_bytes(p)
                                     for p in pieces)
                if not external and OC.should_go_external(pending_bytes,
                                                          conf):
                    external = True
                    P.event(P.EV_OOCORE_DEGRADE, op=self.name(),
                            est_bytes=pending_bytes, algo="agg-spill")
                if external and pending_bytes > run_target:
                    flush_state()
            if not partials and not runs:
                return
            if runs:
                flush_state()
                merged = OC.merge_spilled(
                    runs, lambda bs: bs[0] if len(bs) == 1 else
                    self._merge_partials(bs), label=self.name(),
                    what="the spilled aggregation state",
                    metrics=self.metrics, conf=conf)
            else:
                merged = partials[0] if len(partials) == 1 else \
                    self._merge_partials(partials)
        finally:
            for r in runs:
                r.free()
        if self.mode == AggMode.PARTIAL:
            out = merged
        else:
            with self.metrics.timed(M.TOTAL_TIME):
                # one merged group batch: nothing to subdivide, so
                # pressure spills and retries in place
                (out,) = tuple(self.oom_retry_batches(
                    merged, self._evaluate_one, split=False,
                    label=f"{self.name()}.evaluate"))
        if out.num_rows_known:
            out = out.with_capacity(bucket_capacity(out.num_rows))
        self.update_output_metrics(out)
        yield out

    def _groupby_one(self, batch: ColumnarBatch) -> ColumnarBatch:
        """One batch through a grouping lane -> partial-layout batch."""
        if self._pre_stage is not None and not self._fused_event_done:
            # the profiler's stage_fused event, once per exec
            self._fused_event_done = True
            P.event(P.EV_STAGE_FUSED,
                    members=self._pre_stage.member_names()
                    + [type(self).__name__],
                    exprs=self._pre_stage.expr_count)
        fast = self._dict_groupby_batch(batch)
        if fast is not None:
            return fast
        phase = "merge" if self.mode == AggMode.FINAL else "update"
        wcap = self._kernel_compact_cap(batch)
        cols, n, coll, excess, cert = self._groupby_sorted(batch, phase,
                                                           wcap)
        checks = self._register_collision_check(coll, batch.checks)
        checks = self._register_excess_check(excess, wcap, checks)
        checks = self._register_banded_check(cert, checks)
        return ColumnarBatch(self._partial_schema(), cols, n, checks)

    def _get_merge_exec(self, inter_schema) -> "HashAggregateExec":
        """Internal FINAL-mode exec that merges partial batches."""
        if self._merge_exec is None:
            self._merge_exec = HashAggregateExec(
                [GroupRef(i, f.dtype)
                 for i, f in enumerate(self._group_fields)],
                [AggAlias(f, a.name)
                 for f, a in zip(self._funcs, self.aggregates)],
                SchemaOnlyExec(inter_schema), mode=AggMode.FINAL)
        return self._merge_exec

    def _merge_partials(self, partials) -> ColumnarBatch:
        """Concatenated partials merged by the internal FINAL exec, under
        the OOM harness: on reservation failure the concatenation splits
        and each half merges alone; a key may then sit in several
        outputs, so they merge again (each round shrinks toward the
        group count, and the row floor bounds the recursion)."""
        inter_schema = self._partial_schema()
        merged = concat_batches(partials, sparse_ok=True)
        merge_exec = self._get_merge_exec(inter_schema)
        outs = list(self.oom_retry_batches(
            merged, lambda b: self._merge_one(merge_exec, b),
            label=f"{self.name()}.mergePartials"))
        if len(outs) == 1:
            return outs[0]
        if sum(o.num_rows for o in outs) >= merged.num_rows:
            # no progress: every half still held (nearly) every key, so
            # merging the halves again would loop at the same row count
            # under a sustained reservation failure; merge the whole
            # state once, unreserved, as the split floor does
            log.warning(
                "%s.mergePartials: split-retry not converging (%d rows "
                "-> %d across %d outputs); merging unreserved",
                self.name(), merged.num_rows,
                sum(o.num_rows for o in outs), len(outs))
            return self._merge_one(merge_exec,
                                   concat_batches(outs, sparse_ok=True))
        return self._merge_partials(outs)

    def _merge_one(self, merge_exec, merged: ColumnarBatch
                   ) -> ColumnarBatch:
        wcap = self._kernel_compact_cap(merged)
        cols, n, coll, excess, cert = merge_exec._groupby_sorted(
            merged, "merge", wcap)
        checks = merge_exec._register_collision_check(coll, merged.checks)
        # escalation and the banded deopt are learned on this (outer)
        # exec; its recovery also disables the merge exec's banded lane
        checks = self._register_excess_check(excess, wcap, checks)
        checks = self._register_banded_check(cert, checks)
        return ColumnarBatch(self._partial_schema(), cols, n, checks)

    def _partial_schema(self) -> T.Schema:
        if self.mode == AggMode.FINAL:
            return self._child_schema  # child already emits partial layout
        fields = list(self._group_fields)
        for a, ts in zip(self.aggregates, self._inter_types):
            for j, it in enumerate(ts):
                fields.append(T.Field(f"{a.name}#{j}", it))
        return T.Schema(tuple(fields))

    # -- no-group-key reduction ----------------------------------------------
    def _reduction_path(self, batches) -> Iterator[ColumnarBatch]:
        """Each batch reduces to one partial row (`_reduce_one`), the rows
        merge, and FINAL/COMPLETE evaluate.  SQL: an aggregate of no rows
        is still one row (COUNT = 0, SUM = null)."""
        inter_schema = self._partial_schema()
        phase = "merge" if self.mode == AggMode.FINAL else "update"
        partials = []
        for b in batches:
            if not b.maybe_nonempty():
                continue
            with self.metrics.timed(M.TOTAL_TIME):
                # whole-batch reductions are row-local too: split halves
                # just add one-row partials to the merge below
                partials.extend(self.oom_retry_batches(
                    b, lambda p: self._reduce_one(p, phase, inter_schema),
                    label=f"{self.name()}.reduce"))
        if not partials:
            partials = [self._empty_partial(inter_schema)]
        # always merge, even one partial: it normalizes the empty-input
        # partial's invalid count into a valid 0
        merged = self._merge_reduction(partials, inter_schema)
        out = (merged if self.mode == AggMode.PARTIAL
               else self._evaluate_one(merged))
        self.update_output_metrics(out)
        yield out

    def _reduce_one(self, batch: ColumnarBatch, phase: str,
                    inter_schema: T.Schema) -> ColumnarBatch:
        return ColumnarBatch(inter_schema, self._reduce_kernel(batch, phase),
                             1, batch.checks)

    @kp_site(lambda batch, phase: f"agg-reduce-{phase}")
    def _reduce_kernel(self, batch: ColumnarBatch, phase: str) -> list:
        """Whole-batch reduction of every aggregate: one segment over all
        rows, read at the last row.  Outputs are MIN_CAPACITY long, the
        result in row 0."""
        cap = batch.capacity
        ctx = (self._make_ctx(batch) if phase == "update" else
               make_eval_context(batch.columns, cap, batch.num_rows_i32,
                                 batch.sparse))
        dev = ctx.device
        iota = torch.arange(cap, device=dev)
        actx = AggContext(
            torch.zeros(cap, dtype=torch.int32, device=dev), cap,
            ctx.row_mask, bounds=iota == 0,
            ends=torch.full((MIN_CAPACITY,), cap - 1, dtype=torch.int32,
                            device=dev),
            out_capacity=MIN_CAPACITY)
        if phase == "update":
            inputs_per_f = [[e.eval(ctx) for e in bins]
                            for bins in self._bound_inputs]
        else:
            inputs_per_f = [[ctx.columns[i] for i in range(lo, hi)]
                            for lo, hi in self._inter_offsets]
        return [o for outs in run_agg_phase(actx, self._funcs, inputs_per_f,
                                            phase) for o in outs]

    def _merge_reduction(self, partials, inter_schema) -> ColumnarBatch:
        merged = concat_batches(partials)
        agg = self._get_merge_exec(inter_schema)
        return ColumnarBatch(inter_schema,
                             agg._reduce_kernel(merged, "merge"), 1,
                             merged.checks)

    def _empty_partial(self, inter_schema) -> ColumnarBatch:
        # one row of "no inputs seen": validity false, counts zero
        e = empty_batch(inter_schema, self.device())
        return ColumnarBatch(inter_schema, e.columns, 1)


@dataclasses.dataclass(eq=False)
class GroupRef(Expression):
    """Positional reference used by the merge stage (keys sit at fixed
    positions in partial batches)."""
    ordinal: int
    dtype: T.DataType

    def data_type(self, schema):
        return self.dtype

    def eval(self, ctx):
        return ctx.columns[self.ordinal]
