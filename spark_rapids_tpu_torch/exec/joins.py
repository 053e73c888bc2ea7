"""Equi-joins (port of spark_rapids_tpu/exec/joins.py: JoinType and
HashJoinExec with its sort-merge and dense direct-address lanes).

Sort-merge lane, exact and collision-free:

  1. concatenate build and probe rows and sort them stably by the join
     keys with a side flag as the last key, so build rows come first
     within each key group;
  2. segment boundaries over the sorted keys give the key groups; each
     group records its first sorted row and its build-row count;
  3. a probe row's match count is its group's build count (0 when any
     of its keys is null: SQL equi-join semantics), and a cumsum +
     searchsorted expansion enumerates the (probe, build) pairs.

The pair total decides the output capacity, so it is read back once per
probe batch (with the probe row count and the unmatched probe rows, in
one readback); no other step of a probe batch waits for the host.

Dense lane: a single integral build key with unique values whose span
fits spark.rapids.tpu.denseJoin.maxSpan becomes a slot table (slot =
key - kmin holding build row + 1), and each probe batch is a lookup
into it.  Its entry tests are the reference's, word for word, so both
packages take the same lane on the same data.

Join types: inner, left/right/full outer, left semi, left anti.  A
residual condition filters an inner join's pairs.  Not ported: the
grace-hash out-of-core lane (it needs memory/oocore.py's device budget),
BroadcastHashJoinExec, NestedLoopJoinExec and CartesianProductExec.
"""
from __future__ import annotations

import enum
from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   concat_batches,
                                                   empty_batch)
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector, _pad_chars,
                                                    bucket_capacity,
                                                    gather_narrowest,
                                                    pack_validity_bits,
                                                    validity_bit_assignment)
from spark_rapids_tpu_torch.exec.base import (RequireSingleBatch,
                                              SchemaOnlyExec, TpuExec,
                                              make_eval_context)
from spark_rapids_tpu_torch.exprs.base import (BoundReference, Expression,
                                               Literal, promote)
from spark_rapids_tpu_torch.ops.sort_encode import (encode_key_bits,
                                                    masked_positions,
                                                    packed_lexsort,
                                                    segment_boundaries)


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    CROSS = "cross"


_PROBE_ONLY = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)


def _lane_counter(name: str):
    """A plain integer launch counter for one join lane: `launches` is
    bumped once per probe batch the lane joins."""
    def bump():
        bump.launches += 1
    bump.__name__ = name
    bump.launches = 0
    return bump


#: probe batches joined on the sort-merge lane, and on the dense lane
sort_merge_lane = _lane_counter("sort_merge_lane")
dense_lane = _lane_counter("dense_lane")


def _combined_key(b: ColumnVector, p: ColumnVector) -> ColumnVector:
    """One key column over build rows then probe rows: strings padded to
    one char capacity, numbers promoted to their common type.  An int64
    key whose two sides both carry an int32 shadow keeps it, so the key
    packs into the side flag's sort word (exact: every value fits)."""
    if b.dtype.is_string:
        cc = max(b.char_cap, p.char_cap)
        b, p = _pad_chars(b, cc), _pad_chars(p, cc)
        return ColumnVector(b.dtype, torch.cat([b.data, p.data]),
                            torch.cat([b.validity, p.validity]),
                            lengths=torch.cat([b.lengths, p.lengths]))
    narrow = None
    if (b.dtype == p.dtype and b.dtype.id == T.TypeId.INT64
            and b.narrow is not None and p.narrow is not None):
        narrow = torch.cat([b.narrow, p.narrow])
    dt = b.dtype if b.dtype == p.dtype else T.common_type(b.dtype, p.dtype)
    b, p = promote(b, dt), promote(p, dt)
    return ColumnVector(dt, torch.cat([b.data, p.data]),
                        torch.cat([b.validity, p.validity]), narrow)


def _group_starts(bounds: torch.Tensor, gid: torch.Tensor,
                  iota: torch.Tensor) -> torch.Tensor:
    """Sorted position of each group's first row, by group id (0 past
    the last group).  Rows that start no group write to slots of their
    own past the table, so no two writes meet (a shared sentinel slot
    would take every such write at one address)."""
    cap = bounds.shape[0]
    out = torch.zeros(2 * cap, dtype=torch.int64, device=bounds.device)
    out.scatter_(0, torch.where(bounds, gid, cap + iota), iota)
    return out[:cap]


class HashJoinExec(TpuExec):
    """Shuffled hash join: the build side concatenated to one batch, the
    probe side streamed (reference GpuShuffledHashJoinExec)."""

    def __init__(self, join_type: JoinType,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 left: TpuExec, right: TpuExec,
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        self.join_type = join_type
        if condition is not None and join_type not in (
                JoinType.INNER, JoinType.CROSS):
            raise ValueError(
                "residual join conditions only supported for inner joins "
                "(same restriction as the reference GpuHashJoin)")
        self.condition = condition
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        lschema, rschema = left.output_schema(), right.output_schema()
        # probe = left, build = right, except RIGHT_OUTER, which probes
        # the right side
        self._flip = join_type == JoinType.RIGHT_OUTER
        if self._flip:
            self._probe, self._build = right, left
            self._probe_keys = [e.bind(rschema) for e in self.right_keys]
            self._build_keys = [e.bind(lschema) for e in self.left_keys]
        else:
            self._probe, self._build = left, right
            self._probe_keys = [e.bind(lschema) for e in self.left_keys]
            self._build_keys = [e.bind(rschema) for e in self.right_keys]
        if join_type in _PROBE_ONLY:
            self._schema = lschema
        else:
            self._schema = T.Schema(tuple(lschema.fields) +
                                    tuple(rschema.fields))
        # the dense lane: one integral key, no residual condition, and a
        # join type whose output is a per-probe-row lookup (FULL_OUTER
        # also emits unmatched build rows: sort-merge lane)
        self._dense_qual = (
            condition is None and
            len(self._probe_keys) == 1 and
            self._probe_keys[0].data_type(
                self._probe.output_schema()).is_integral and
            self._build_keys[0].data_type(
                self._build.output_schema()).is_integral and
            join_type in (JoinType.INNER, JoinType.LEFT_OUTER,
                          JoinType.RIGHT_OUTER, JoinType.LEFT_SEMI,
                          JoinType.LEFT_ANTI))
        self._cond_filter = None
        #: the lane the last execution took: "dense" or "sort-merge"
        self.lane: Optional[str] = None

    def output_schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        return (f"HashJoinExec({self.join_type.value}, "
                f"keys={len(self.left_keys)})")

    def children_coalesce_goal(self):
        # the build side must be one batch
        return [None, RequireSingleBatch()] if not self._flip else \
            [RequireSingleBatch(), None]

    def output_partition_count(self) -> int:
        return 1

    def execute_partitions(self):
        return [self.execute_columnar()]

    # -- the sort-merge lane ----------------------------------------------
    def _match(self, build: ColumnarBatch, probe: ColumnarBatch,
               want_bmatched: bool):
        """Per probe row its match count and the sorted position of its
        group's first build row; the sort permutation; the build rows
        matched by this batch (FULL_OUTER only); and [pair total,
        unmatched live probe rows, live probe rows] as one device
        vector."""
        bcap, pcap = build.capacity, probe.capacity
        cap = bcap + pcap
        dev = build.device
        bctx = make_eval_context(build.columns, bcap, build.num_rows_i32)
        pctx = make_eval_context(probe.columns, pcap, probe.num_rows_i32)
        comb = [_combined_key(b.eval(bctx), p.eval(pctx))
                for b, p in zip(self._build_keys, self._probe_keys)]
        iota = torch.arange(cap, device=dev)
        side = (iota >= bcap).to(torch.int64)
        row_mask = torch.cat([bctx.row_mask, pctx.row_mask])
        keys_msf = [((~row_mask).to(torch.int64), 1)]
        for c in comb:
            keys_msf.extend(encode_key_bits(c, True, True))
        keys_msf.append((side, 1))
        perm = packed_lexsort(keys_msf)
        bounds = segment_boundaries(comb, perm, row_mask)
        keys_ok = row_mask
        for c in comb:
            keys_ok = keys_ok & c.validity
        sorted_ok = keys_ok[perm]
        is_probe = (perm >= bcap) & sorted_ok
        is_build = (perm < bcap) & sorted_ok
        # each sorted row's group and its group's first row; invalid rows
        # sort last and only extend the last group, as rows of neither
        # side
        gid = torch.cumsum(bounds, 0) - 1
        starts = _group_starts(bounds, gid, iota)
        gstart = starts[gid.clamp(min=0)]
        # a group's build rows lead it, so a probe row's count of build
        # rows since its group start is the group's whole build count
        nb = torch.cumsum(is_build, 0)
        cnt = torch.where(is_probe, nb - (nb - is_build.to(torch.int64))
                          [gstart], 0)
        # the inverse permutation takes sorted rows back to input rows
        # (every slot written once)
        inv = torch.empty_like(perm).scatter_(0, perm, iota)
        pos = inv[bcap:]
        counts_p = cnt[pos]
        start_p = torch.where(is_probe, gstart, 0)[pos]
        bmatched = None
        if want_bmatched:
            # a build row is matched when its group holds a probe row:
            # count them up to the group's end, the next group's start
            nxt = (gid + 1).clamp(max=cap - 1)
            end = torch.where(gid + 1 < bounds.sum(), starts[nxt],
                              row_mask.sum())
            npr = torch.cumsum(is_probe, 0)
            probes = npr[(end - 1).clamp(min=0)] - \
                (npr - is_probe.to(torch.int64))[gstart]
            bmatched = (is_build & (probes > 0))[inv[:bcap]]
        probe_live = pctx.row_mask
        stats = torch.stack([
            counts_p.sum(),
            (probe_live & (counts_p == 0)).sum(),
            probe_live.sum()])
        return counts_p, start_p, perm, bmatched, stats

    @staticmethod
    def _expand(build: ColumnarBatch, probe: ColumnarBatch,
                counts_p: torch.Tensor, start_p: torch.Tensor,
                perm: torch.Tensor, out_cap: int, outer_probe: bool):
        """Gather the (probe, build) pairs into `out_cap` rows: output row
        k belongs to probe row i = searchsorted(cumsum, k, right) and
        takes the (k - cum[i - 1])-th build row of its group; an
        unmatched probe row of an outer join takes one row with a null
        build side."""
        bcap, pcap = build.capacity, probe.capacity
        cap = bcap + pcap
        dev = probe.device
        eff = counts_p
        if outer_probe:
            live = torch.arange(pcap, device=dev) < probe.num_rows_i32
            eff = torch.where(live & (counts_p == 0), 1, counts_p)
        cum = torch.cumsum(eff, 0)
        total = cum[-1]
        k = torch.arange(out_cap, device=dev)
        i = torch.searchsorted(cum, k, right=True).clamp(0, pcap - 1)
        prev = torch.where(i > 0, cum[(i - 1).clamp(min=0)], 0)
        in_range = k < total
        has_match = counts_p[i] > 0
        sorted_bpos = (start_p[i] + (k - prev)).clamp(0, cap - 1)
        build_row = perm[sorted_bpos].clamp(0, bcap - 1)
        probe_sel = torch.where(in_range, i, 0)
        bvalid = in_range & has_match
        build_sel = torch.where(bvalid, build_row, 0)
        pout = [c.gather(probe_sel, in_range) for c in probe.columns]
        bout = [c.gather(build_sel, bvalid) for c in build.columns]
        return pout, bout

    def _semi(self, probe: ColumnarBatch, counts_p: torch.Tensor,
              anti: bool) -> ColumnarBatch:
        """The probe rows with (semi) or without (anti) a match, compacted
        on the device; the row count stays there."""
        pcap = probe.capacity
        dev = probe.device
        live = torch.arange(pcap, device=dev) < probe.num_rows_i32
        keep = live & ((counts_p == 0) if anti else (counts_p > 0))
        n = keep.sum().to(torch.int32)
        idx = masked_positions(keep, pcap, pcap - 1)
        valid = torch.arange(pcap, device=dev) < n
        return ColumnarBatch(self._schema,
                             [c.gather(idx, valid) for c in probe.columns],
                             n, probe.checks)

    def _join_stream(self, build: ColumnarBatch,
                     probe_batches) -> Iterator[ColumnarBatch]:
        """The sort-merge join of one whole build batch against a stream
        of probe batches."""
        jt = self.join_type
        outer_probe = jt in (JoinType.LEFT_OUTER, JoinType.RIGHT_OUTER,
                             JoinType.FULL_OUTER)
        full = jt == JoinType.FULL_OUTER
        bmatched_total = (torch.zeros(build.capacity, dtype=torch.bool,
                                      device=build.device)
                          if full else None)

        def probe_one(pb: ColumnarBatch) -> ColumnarBatch:
            pb = pb.dense()
            sort_merge_lane()
            counts_p, start_p, perm, bmatched, stats = self._match(
                build, pb, full)
            if full:
                bmatched_total.logical_or_(bmatched)
            if jt in _PROBE_ONLY:
                return self._semi(pb, counts_p, jt == JoinType.LEFT_ANTI)
            # the one host read of a probe batch: the pair total sizes
            # the output
            total_inner, unmatched, live = stats.tolist()
            bound = total_inner + (live if outer_probe else 0)
            out_cap = bucket_capacity(max(bound, 1))
            pout, bout = self._expand(build, pb, counts_p, start_p, perm,
                                      out_cap, outer_probe)
            n = total_inner + (unmatched if outer_probe else 0)
            out = self._assemble(pout, bout, n)
            if self.condition is not None:
                out = self._apply_condition(out)
            return out

        for pb in probe_batches:
            if not pb.maybe_nonempty():
                continue
            out = probe_one(pb)
            if out.maybe_nonempty():
                yield out
        if full:
            un = self._unmatched_build(build, bmatched_total)
            if un is not None:
                yield un

    def _apply_condition(self, batch: ColumnarBatch) -> ColumnarBatch:
        from spark_rapids_tpu_torch.exec.basic import FilterExec
        if self._cond_filter is None:
            self._cond_filter = FilterExec(self.condition,
                                           SchemaOnlyExec(self._schema))
        (out,) = self._cond_filter.process_partition(iter([batch]))
        return out

    def _unmatched_build(self, build: ColumnarBatch,
                         matched: torch.Tensor) -> Optional[ColumnarBatch]:
        """FULL OUTER: the build rows no probe row matched, with a null
        probe side."""
        dev = build.device
        live = torch.arange(build.capacity, device=dev) < build.num_rows_i32
        unmatched = live & ~matched
        n = int(unmatched.sum().item())
        if n == 0:
            return None
        cap = bucket_capacity(n)
        sel = masked_positions(unmatched, cap, 0)
        valid = torch.arange(cap, device=dev) < n
        bout = [c.gather(sel, valid) for c in build.columns]
        ctx = make_eval_context(bout, cap, n)
        nulls = [Literal(None, f.dtype).eval(ctx)
                 for f in self._probe.output_schema().fields]
        return self._assemble(nulls, bout, n)

    def _assemble(self, pout, bout, n) -> ColumnarBatch:
        """Output columns as (left, right) whichever side probed."""
        cols = list(bout) + list(pout) if self._flip else \
            list(pout) + list(bout)
        return ColumnarBatch(self._schema, cols, n)

    # -- the dense direct-address lane ------------------------------------
    def _try_dense_table(self, build: ColumnarBatch):
        """(kmin, g, bidx1 table, packed-validity table) of the build
        side, or None where it does not qualify: the reference's tests,
        in its order (capacity under 2^24 and a multiple of 128, span
        within denseJoin.maxSpan, unique keys)."""
        conf = C.get_active_conf()
        if not conf[C.DENSE_JOIN_ENABLED]:
            return None
        if build.capacity >= (1 << 24) or build.capacity % 128:
            return None
        key = self._build_keys[0]
        ctx = make_eval_context(build.columns, build.capacity,
                                build.num_rows_i32)
        k = key.eval(ctx)
        ok = k.validity & ctx.row_mask
        kd = (k.narrow if k.narrow is not None else k.data).to(torch.int64)
        big = torch.iinfo(torch.int64)
        kmin, kmax = torch.stack([
            torch.where(ok, kd, big.max).min(),
            torch.where(ok, kd, big.min).max()]).tolist()
        span = kmax - kmin + 1 if kmax >= kmin else 0
        if span > int(conf[C.DENSE_JOIN_MAX_SPAN]):
            return None
        g = bucket_capacity(max(span, 1))
        off = kd - kmin
        in_t = ok & (off >= 0) & (off < g)
        # masked rows go to the sentinel slot g, which is cut off
        slots = torch.where(in_t, off, g)
        cnt = torch.zeros(g + 1, dtype=torch.int32, device=kd.device)
        cnt.scatter_add_(0, slots, in_t.to(torch.int32))
        if int(cnt[:g].max().item()) > 1:
            return None  # duplicate build keys
        # unique keys: one table holds the build row + 1 (0 = empty slot)
        rows1 = torch.arange(1, build.capacity + 1, dtype=torch.int32,
                             device=kd.device)
        bidx1 = torch.zeros(g + 1, dtype=torch.int32, device=kd.device)
        bidx1.scatter_add_(0, slots, torch.where(in_t, rows1, 0))
        # every non-string build column's validity in one bitmask per slot
        _, packed = pack_validity_bits(build.columns)
        if packed is None:
            packed = torch.zeros(build.capacity, dtype=torch.int32,
                                 device=kd.device)
        vmask = torch.zeros(g + 1, dtype=torch.int32, device=kd.device)
        vmask.scatter_add_(0, slots, torch.where(in_t, packed, 0))
        return kmin, g, bidx1, vmask

    def _dense_key_remat_ordinal(self) -> Optional[int]:
        """Ordinal of the build column the build key reads directly, or
        None: on an equi-join its matched values equal the probe key's,
        so the probe key stands in for its gather."""
        bk = self._build_keys[0]
        return bk.ordinal if isinstance(bk, BoundReference) else None

    def _dense_probe(self, build: ColumnarBatch, pb: ColumnarBatch,
                     tab, narrow_ok: bool) -> ColumnarBatch:
        kmin, g, bidx1, vmask = tab
        jt = self.join_type
        ctx = make_eval_context(pb.columns, pb.capacity, pb.num_rows_i32,
                                pb.sparse)
        pk = self._probe_keys[0].eval(ctx)
        ok = pk.validity & ctx.row_mask
        # narrow_ok: [kmin, kmin + g) lies in int32, so the int32 shadow
        # is an exact stand-in for the key (a key outside int32 has none)
        kd = pk.narrow if pk.narrow is not None and narrow_ok else pk.data
        off = kd.to(torch.int64) - kmin
        in_t = ok & (off >= 0) & (off < g)
        slot = torch.where(in_t, off, g)
        bsel1 = bidx1[slot]
        matched = in_t & (bsel1 > 0)
        if jt in _PROBE_ONLY:
            keep = (ctx.row_mask & ~matched if jt == JoinType.LEFT_ANTI
                    else matched)
            return ColumnarBatch(self._schema, pb.columns, None, pb.checks,
                                 sparse=keep)
        bsel = torch.where(matched, bsel1 - 1, 0)
        vm = vmask[slot]
        vbits = validity_bit_assignment(build.columns)
        remat = self._dense_key_remat_ordinal()
        bout = []
        for ci, c in enumerate(build.columns):
            if ci in vbits:
                valid = matched & (((vm >> vbits[ci]) & 1) != 0)
            else:
                valid = matched & c.validity[bsel.to(torch.int64)]
            if (remat == ci and pk.data.dtype == c.data.dtype
                    and not c.dtype.is_string):
                # matched implies the build key is non-null
                bout.append(ColumnVector(c.dtype, pk.data, matched,
                                         pk.narrow))
            elif c.dtype.is_string:
                bout.append(c.gather(bsel, matched))
            else:
                bout.append(gather_narrowest(c, bsel, valid))
        pcols = list(pb.columns)
        cols = bout + pcols if self._flip else pcols + bout
        if jt == JoinType.INNER:
            return ColumnarBatch(self._schema, cols, None, pb.checks,
                                 sparse=matched)
        # LEFT/RIGHT OUTER: every probe row stays
        return ColumnarBatch(self._schema, cols, pb._rows, pb.checks,
                             sparse=pb.sparse)

    def _execute_dense(self, build, tab) -> Iterator[ColumnarBatch]:
        kmin, g = tab[0], tab[1]
        i32 = torch.iinfo(torch.int32)
        narrow_ok = i32.min <= kmin and kmin + g <= i32.max
        for it in self._probe.execute_partitions():
            for pb in it:
                if not pb.maybe_nonempty():
                    continue
                dense_lane()
                out = self._dense_probe(build, pb, tab, narrow_ok)
                if out.maybe_nonempty():
                    yield out

    # -- execution --------------------------------------------------------
    def _build_batch(self) -> ColumnarBatch:
        batches = [b.dense() for it in self._build.execute_partitions()
                   for b in it if b.maybe_nonempty()]
        if not batches:
            return empty_batch(self._build.output_schema(),
                               self._build.device())
        return concat_batches(batches)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        # The reference's grace-hash lane is not here: it spills both
        # sides by key hash when memory/oocore.py's should_go_external
        # says the build side overflows the device budget, which needs a
        # DeviceManager (not ported); without one the reference never
        # takes it either.
        build = self._build_batch()
        if self._dense_qual:
            tab = self._try_dense_table(build)
            if tab is not None:
                self.lane = "dense"
                yield from self._execute_dense(build, tab)
                return
        self.lane = "sort-merge"
        yield from self._join_stream(
            build, (pb for it in self._probe.execute_partitions()
                    for pb in it))
