"""The mesh all-to-all exchange (port of
spark_rapids_tpu/parallel/collective_exchange.py).

The reference pushes rows between the devices of its mesh with one
`lax.all_to_all` inside a `shard_map`.  The port's single controller
does the same push over the slots of a `parallel/mesh.py` Mesh:

  per device group (the slots of one physical device, batched):
    1. murmur3 partition ids of each slot's live rows (the bits of the
       CPU path and of the reference);
    2. a stable sort of each slot's rows by destination slot, and the
       per-destination counts;
    3. a scatter of the rows into [slots, n, cap] send blocks;
  then
    4. the counts cross as an [n, n] exchange, and each destination
       sizes its output from them (the count phase);
    5. the blocks cross slot to slot: where all slots share one device
       this is the transpose of the [n_src, n_dst, cap] stack, read in
       place by the gather of step 6; otherwise each (source group,
       destination group) pair is one copy between the devices;
    6. each destination compacts what it received (cumsum and
       searchsorted over its received counts) into `out_cap` rows, the
       sources' blocks in slot order.

Every (source, destination) block holds `cap` rows, the worst case, so
no row can overflow.  The outputs gather to the mesh's home device,
where the rest of the engine runs.  `build_all_to_all_exchange` and
`build_count_exchange` return plain callables: PyTorch runs eagerly, so
there is no compiled step to cache.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.ops.murmur3 import partition_ids
from spark_rapids_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, data_sharding


def watched_collective(thunk, label: str = "all-to-all", nbytes: int = 0):
    """Run one collective step under a collective-class watchdog
    heartbeat (the tighter `spark.rapids.sql.watchdog.collectiveTimeout`
    deadline and the `collective` hang-injection site): a mesh step
    holds every slot at once.  `nbytes`, the payload the step moves over
    the mesh, goes on the movement ledger's collective edge, timed over
    the step."""
    from spark_rapids_tpu_torch.utils import movement as MV
    from spark_rapids_tpu_torch.utils import watchdog as W
    with W.heartbeat(f"collective:{label}", kind="collective") as hb:
        W.check_cancelled()
        W.maybe_hang("collective")
        t0 = time.perf_counter_ns()
        out = thunk()
        if nbytes:
            MV.record(MV.EDGE_COLLECTIVE, nbytes, site=label,
                      dur_ns=time.perf_counter_ns() - t0)
        hb.beat()
        return out


def stacked_payload_bytes(arrs) -> int:
    """The ledger convention both mesh lanes share (this exchange and
    the SPMD gang, exec/spmd.py): a collective's payload is the bytes of
    the stacked tensors entering it (data, validity and string
    lengths)."""
    total = 0
    for field in arrs:
        for a in field:
            if a is not None:
                total += a.numel() * a.element_size()
    return total


def _local_split(cols, num_rows, key_idx, n_dev: int, cap: int):
    """The send side of the slots of one device: `cols` hold k slots of
    `cap` rows back to back, `num_rows` is int32[k].  Returns (scatter,
    counts): `scatter(x)` lays a [k*cap, ...] tensor out as [k, n_dev,
    cap, ...] send blocks (each slot's rows grouped by destination, in
    row order), and counts is int64[k, n_dev]."""
    dev = num_rows.device
    k = num_rows.shape[0]
    rows = k * cap
    iota = torch.arange(rows, device=dev)
    slot = iota // cap
    live = (iota - slot * cap) < num_rows.to(torch.int64)[slot]
    pids = partition_ids([cols[i] for i in key_idx], n_dev).to(torch.int64)
    pids = torch.where(live, pids, n_dev)
    block = slot * (n_dev + 1) + pids
    order = torch.sort(block, stable=True).indices
    sizes = torch.bincount(block, minlength=k * (n_dev + 1))
    starts = torch.cumsum(sizes, 0) - sizes
    sblock = block[order]
    within = iota - starts[sblock]
    spid = sblock % (n_dev + 1)
    # padded and dead rows go to one spare row past the blocks, dropped
    dest = torch.where(spid < n_dev,
                       ((sblock // (n_dev + 1)) * n_dev + spid) * cap
                       + within, k * n_dev * cap)

    def scatter(x: torch.Tensor) -> torch.Tensor:
        buf = x.new_zeros((k * n_dev * cap + 1,) + tuple(x.shape[1:]))
        buf[dest] = x[order]
        return buf[:-1].view((k, n_dev, cap) + tuple(x.shape[1:]))

    return scatter, sizes.view(k, n_dev + 1)[:, :n_dev]


class MeshRound:
    """One exchange round over a mesh: the send side split per device
    group on construction, then the count phase (`recv_totals`) and the
    data phase (`exchange`)."""

    def __init__(self, arrs, num_rows, schema: T.Schema, key_idx,
                 mesh: Mesh, axis: str, cap: int):
        self.mesh, self.cap, self.schema = mesh, cap, schema
        self.n = mesh.shape[axis]
        place = data_sharding(mesh, axis)
        self.arrs = [tuple(None if a is None else place.put(a)
                           for a in field) for field in arrs]
        rows = place.put(num_rows.to(torch.int32))
        self.scatters, self.counts = [], []
        for g in range(len(mesh.groups)):
            k = rows[g].shape[0]
            cols = []
            for f, (data, validity, lengths) in zip(schema.fields, self.arrs):
                cols.append(ColumnVector(
                    f.dtype, _flat(data[g], k * cap),
                    _flat(validity[g], k * cap),
                    lengths=None if lengths is None
                    else _flat(lengths[g], k * cap)))
            scatter, counts = _local_split(cols, rows[g], key_idx, self.n,
                                           cap)
            self.scatters.append(scatter)
            self.counts.append(counts)
        self._recv = None

    def recv_counts(self) -> list:
        """Per device group, int64[slots, n_src]: the rows each of the
        group's slots receives from every source slot (the counts'
        [n, n] exchange)."""
        if self._recv is None:
            groups = self.mesh.groups
            if len(groups) == 1:
                self._recv = [self.counts[0].t()]
            else:
                self._recv = []
                for dev_h, slots_h in groups:
                    rc = torch.zeros((len(slots_h), self.n),
                                     dtype=torch.int64, device=dev_h)
                    for (_, slots_g), c in zip(groups, self.counts):
                        rc[:, list(slots_g)] = c[:, list(slots_h)].t().to(
                            dev_h, non_blocking=True)
                    self._recv.append(rc)
        return self._recv

    def recv_totals(self) -> torch.Tensor:
        """int32[n] on the home device: the rows each slot receives."""
        place = data_sharding(self.mesh, self.mesh.axis_names[0])
        return place.gather([rc.sum(1).to(torch.int32)
                             for rc in self.recv_counts()])

    def _blocks(self, sends: list, h: int) -> torch.Tensor:
        """Group h's received blocks, laid out [n_src, k_h, cap, ...]:
        the send stack itself on a mesh of one device (its transpose is
        read in place), else one copy per source group."""
        groups = self.mesh.groups
        if len(groups) == 1:
            return sends[0]
        dev_h, slots_h = groups[h]
        first = sends[0]
        recv = first.new_zeros((self.n, len(slots_h))
                               + tuple(first.shape[2:]), device=dev_h)
        for (_, slots_g), s in zip(groups, sends):
            recv[list(slots_g)] = s[:, list(slots_h)].to(
                dev_h, non_blocking=True)
        return recv

    def exchange(self, out_cap: int) -> tuple:
        """The data phase: (per field (data, validity, lengths|None) as
        [n, out_cap, ...] on the home device, int32[n] received rows)."""
        groups = self.mesh.groups
        n, cap = self.n, self.cap
        place = data_sharding(self.mesh, self.mesh.axis_names[0])
        picks = []
        for h, ((dev_h, slots_h), rc) in enumerate(zip(groups,
                                                       self.recv_counts())):
            k_h = len(slots_h)
            csum = torch.cumsum(rc, 1)
            starts = csum - rc
            want = torch.arange(out_cap, device=dev_h).expand(k_h, out_cap)
            src = torch.searchsorted(csum, want.contiguous(), right=True
                                     ).clamp(max=n - 1)
            off = want - torch.gather(starts, 1, src)
            ok = want < csum[:, -1:]
            jl = torch.arange(k_h, device=dev_h)[:, None]
            flat = torch.where(ok, (src * k_h + jl) * cap + off, 0)
            picks.append((flat, ok))
        out = []
        for field in self.arrs:
            res = []
            for part in field:
                if part is None:
                    res.append(None)
                    continue
                sends = [sc(_flat(p, p.shape[0] * cap))
                         for sc, p in zip(self.scatters, part)]
                chunks = []
                for h, (flat, ok) in enumerate(picks):
                    recv = self._blocks(sends, h)
                    got = recv.reshape((-1,) + tuple(recv.shape[3:]))[flat]
                    mask = ok.view(ok.shape + (1,) * (got.dim() - 2))
                    chunks.append(got & mask if got.dtype == torch.bool
                                  else torch.where(mask, got, 0))
                    del recv
                del sends
                res.append(place.gather(chunks))
            out.append(tuple(res))
        return out, self.recv_totals()


def _flat(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.reshape((rows,) + tuple(x.shape[2:]))


def exchange_local(local, num_rows, schema: T.Schema, key_idx, mesh: Mesh,
                   cap: int, axis: str = DATA_AXIS,
                   out_cap: Optional[int] = None) -> tuple:
    """The whole all-to-all over `mesh` in one call (the reference's
    per-device body, here for every slot at once).  `local`: per field
    (data, validity, lengths|None) stacked [n, cap, ...]; `num_rows`
    int32[n].  `out_cap` sizes each slot's received batch: n*cap is the
    worst case (every slot sends all its rows to one), the default (cap)
    is safe only when the caller pre-padded capacity.  Returns (per
    field (data, validity, lengths|None) [n, out_cap, ...], int32[n]
    received rows), on the mesh's home device."""
    return MeshRound(local, num_rows, schema, tuple(key_idx), mesh, axis,
                      cap).exchange(cap if out_cap is None else out_cap)


def build_all_to_all_exchange(mesh: Mesh, axis: str, schema: T.Schema,
                              key_indices: Sequence[int], capacity: int,
                              out_capacity: Optional[int] = None):
    """A step `(stacked arrs, num_rows[n]) -> (exchanged arrs,
    num_rows[n])`; `out_capacity` (default `capacity`) sizes the received
    batches.  Layout per field: data [n, cap, ...], validity [n, cap],
    lengths or None."""
    key_idx = tuple(key_indices)

    def step(arrs, num_rows):
        return exchange_local(arrs, num_rows, schema, key_idx, mesh,
                              capacity, axis, out_cap=out_capacity)
    return step


def build_count_exchange(mesh: Mesh, axis: str, schema: T.Schema,
                         key_indices: Sequence[int], capacity: int):
    """The count phase alone: `(arrs, num_rows[n]) -> int32[n]`, the rows
    each slot would receive, so the data phase sizes its output from the
    real totals instead of the n*cap worst case."""
    key_idx = tuple(key_indices)

    def counts(arrs, num_rows):
        return MeshRound(arrs, num_rows, schema, key_idx, mesh, axis,
                          capacity).recv_totals()
    return counts


def stack_batches(batches, capacity: int) -> tuple:
    """Stack per-slot ColumnarBatches into the layout above: per field
    (data, validity, lengths|None) as [n, capacity, ...] (strings padded
    to a shared char capacity), and int32[n] row counts, on the
    batches' device.  Sparse batches are compacted first."""
    from spark_rapids_tpu_torch.columnar.vector import _pad_chars
    batches = [b.dense().with_capacity(capacity) for b in batches]
    schema = batches[0].schema
    arrs = []
    for ci, f in enumerate(schema.fields):
        vecs = [b.columns[ci] for b in batches]
        if f.dtype.is_string:
            cc = max(v.char_cap for v in vecs)
            vecs = [_pad_chars(v, cc) for v in vecs]
        arrs.append((torch.stack([v.data for v in vecs]),
                     torch.stack([v.validity for v in vecs]),
                     torch.stack([v.lengths for v in vecs])
                     if f.dtype.is_string else None))
    num_rows = torch.stack([b.num_rows_i32 for b in batches])
    return arrs, num_rows


def unstack_batches(arrs, num_rows, schema: T.Schema) -> list:
    """One ColumnarBatch per slot of a stacked layout; `num_rows` a
    sequence of host ints (or a tensor, read back once)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    if isinstance(num_rows, torch.Tensor):
        num_rows = num_rows.cpu().tolist()
    out = []
    for d, rows in enumerate(num_rows):
        cols = [ColumnVector(f.dtype, data[d], validity[d],
                             lengths=None if lengths is None else lengths[d])
                for f, (data, validity, lengths) in zip(schema.fields, arrs)]
        out.append(ColumnarBatch(schema, cols, int(rows)))
    return out
