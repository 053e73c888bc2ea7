"""SPMD whole-stage execution: a fused stage run once over the device
mesh, not once per partition (port of spark_rapids_tpu/exec/spmd.py).

The reference stacks every partition batch of a `FusedStageExec` along
a slot axis, lays the stack over its mesh and runs the composed
project/filter chain as one jit-with-shardings program (`jax.vmap` over
the slots).  The port's gang does the same work eagerly, once per
physical device over all of that device's slots:

  1. drain the stage's child partitions and stack every batch along a
     slot axis, padded to one capacity (and string char capacity), with
     a per-slot row mask so ragged partitions stay exact;
  2. give each device group of the mesh its slots (block-wise, as the
     reference's leading-axis sharding does), flatten them into one
     batch of slots*cap rows under the stacked masks and evaluate the
     composed stage (`plan/fusion.py _eval_stage`) once;
  3. take each slot's output rows from `keep.view(slots, cap).sum(1)`
     and its columns as views of the flat outputs, gathered to the
     mesh's home device, where the rest of the engine runs.

So one card runs one launch sequence per stage, whatever the partition
count.  Padding slots (the reference pads the slot count to a multiple
of the mesh size) carry no rows, so they are counted but not evaluated.

Kept from the per-partition lane: deferred selection (a filter stage's
outputs are sparse batches, a pure-project stage passes each input's row
count and mask through), the OOM harness at gang granularity
(`memory/retry.with_retry` over the stacked bytes), one semaphore hold
for the whole mesh, the process-wide `scheduler.whole_mesh_dispatch`
gate, the collective-class watchdog heartbeat, the residency ledger's
gang entry and the movement ledger's collective edge (site
``spmd-stage``, the gang's outputs, `stacked_payload_bytes`'s
convention).

Deopt to the per-partition lane (never an error): the conf off, no
active mesh, a prior deopt of this exec, an uneven layout the stacker
cannot unify (a narrow shadow on some batches only), a stage with an
expression that reads the task context (spark_partition_id(),
monotonically_increasing_id(), rand(), the input-file leaves: flattened
slots would change its per-batch row positions), or any other failure
to build or run the gang (`numSpmdDeopts`, the `spmd_deopt` event).  The
port has no kernel cache, so there is no `mesh_cache_scope`.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.vector import ColumnVector, _pad_chars
from spark_rapids_tpu_torch.exec.base import make_eval_context
from spark_rapids_tpu_torch.utils import metrics as M

log = logging.getLogger("spark_rapids_tpu_torch.exec.spmd")

#: site label on the movement ledger's collective edge
SITE_SPMD_STAGE = "spmd-stage"


class SpmdUnsupported(Exception):
    """This gang cannot run SPMD (deopt to the per-partition lane)."""


# ---------------------------------------------------------------------------
# lane counters: process-wide, so a caller can show one gang dispatch per
# stage without instrumenting the stage
_STATS_LOCK = threading.Lock()
_STATS = {"gang_dispatches": 0, "gang_batches": 0, "gang_slots": 0,
          "deopts": 0}


def spmd_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_spmd_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(**kv) -> None:
    with _STATS_LOCK:
        for k, v in kv.items():
            _STATS[k] += v


# ---------------------------------------------------------------------------
def maybe_execute_spmd(exec_) -> Optional[list]:
    """The SPMD lane of one `FusedStageExec`: its partition iterators when
    the lane engages, None when the per-partition lane should run (conf
    off, no active mesh, or this exec already deopted).  The conf and the
    mesh are read at execution time, never captured at planning."""
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.utils.watchdog import TpuQueryTimeout
    if not C.get_active_conf()[C.SPMD_ENABLED]:
        return None
    active = PM.get_active_mesh()
    if active is None or exec_._spmd_deopt:
        return None
    mesh, axis = active
    if not PM.same_device(mesh.home, exec_.device()):
        return None  # the mesh serves plans on its home device
    parts = exec_.child.execute_partitions()
    n_parts = len(parts)
    # the gang barrier: one dispatch per stage needs every partition's
    # batches together
    entries = [(pi, b) for pi, it in enumerate(parts) for b in it]
    if not entries:
        return [iter(()) for _ in range(n_parts)]
    outs = None
    try:
        with exec_.metrics.timed(M.TOTAL_TIME):
            outs = _run_gang(exec_, mesh, axis, [b for _, b in entries])
    except (MemoryError, TpuQueryTimeout, torch.cuda.OutOfMemoryError):
        raise  # the OOM harness and the watchdog own these
    except Exception as e:  # noqa: BLE001 — an unsupported gang deopts
        _note_deopt(exec_, e)  # this stage only
    groups: list = [[] for _ in range(n_parts)]
    if outs is None:
        # the per-partition fused lane over the already drained batches
        for pi, b in entries:
            groups[pi].append(b)
        return [exec_.process_partition(iter(g)) for g in groups]
    for (pi, _), ob in zip(entries, outs):
        groups[pi].append(ob)
    return [iter(g) for g in groups]


def _note_deopt(exec_, err: BaseException) -> None:
    from spark_rapids_tpu_torch.utils import profile as P
    exec_._spmd_deopt = True
    exec_.metrics.add(M.NUM_SPMD_DEOPTS, 1)
    _bump(deopts=1)
    P.event(P.EV_SPMD_DEOPT, members=exec_.stage.member_names(),
            error=f"{type(err).__name__}: {err}"[:300])
    log.warning("SPMD gang for stage [%s] deopted to the per-partition "
                "lane: %s", exec_.stage.describe_ops(), err)


# ---------------------------------------------------------------------------
# stacking
def _reads_task_context(e) -> bool:
    from spark_rapids_tpu_torch.exprs.misc import _Leaf
    return isinstance(e, _Leaf) or any(_reads_task_context(c)
                                       for c in e.children())


def _gang_layout(schema: T.Schema, batches: list) -> tuple:
    """The gang's unified layout: (capacity, per-column char capacity).
    Raises SpmdUnsupported for a narrow shadow on some batches only:
    dropping it from some slots would route them through other lanes
    downstream than the per-partition lane's."""
    cap = max(b.capacity for b in batches)
    char_caps: list = []
    for ci, f in enumerate(schema.fields):
        vecs = [b.columns[ci] for b in batches]
        char_caps.append(max(v.char_cap for v in vecs)
                         if f.dtype.is_string else 0)
        with_n = sum(1 for v in vecs if v.narrow is not None)
        if with_n not in (0, len(vecs)):
            raise SpmdUnsupported(
                f"column '{f.name}' carries a narrow shadow on "
                f"{with_n}/{len(vecs)} gang batches: uneven layouts deopt "
                "to the per-partition lane")
    return cap, tuple(char_caps)


def _stack_gang(schema: T.Schema, batches: list, cap: int,
                char_caps: tuple, device) -> tuple:
    """The batches' columns stacked into [k, cap, ...] tensors on
    `device`, and their [k, cap] row masks (a batch's sparse mask, else
    its row-count prefix)."""
    def stack(ts):
        return torch.stack(ts).to(device, non_blocking=True)

    cols: list = []
    for ci, f in enumerate(schema.fields):
        vecs = [b.columns[ci] for b in batches]
        if f.dtype.is_string:
            vecs = [_pad_chars(v, char_caps[ci]) for v in vecs]
        vecs = [v.with_capacity(cap) for v in vecs]
        cols.append(ColumnVector(
            f.dtype, stack([v.data for v in vecs]),
            stack([v.validity for v in vecs]),
            stack([v.narrow for v in vecs])
            if vecs[0].narrow is not None else None,
            stack([v.lengths for v in vecs])
            if vecs[0].lengths is not None else None))

    def mask(b):
        if b.sparse is None:
            return torch.arange(cap, device=b.device) < b.num_rows_i32
        return torch.cat([b.sparse, b.sparse.new_zeros(cap - b.capacity)])

    masks = stack([mask(b) for b in batches])
    return cols, masks


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _vector_tensors(cols) -> list:
    return [t for c in cols for t in (c.data, c.validity, c.narrow,
                                      c.lengths)]


def _flat(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def _slot(t: Optional[torch.Tensor], k: int, cap: int, j: int, home):
    if t is None:
        return None
    return t.view((k, cap) + tuple(t.shape[1:]))[j].to(home,
                                                       non_blocking=True)


# ---------------------------------------------------------------------------
def _run_gang(exec_, mesh, axis: str, batches: list) -> list:
    """Dispatch one gang: stack, evaluate once per device group, slice.
    Returns one output ColumnarBatch per input batch, in order."""
    from spark_rapids_tpu_torch.exec import scheduler as S
    from spark_rapids_tpu_torch.exec.basic import _register_ansi
    from spark_rapids_tpu_torch.memory import retry as R
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.parallel.collective_exchange import (
        watched_collective)
    from spark_rapids_tpu_torch.plan.fusion import _eval_stage
    from spark_rapids_tpu_torch.utils import movement as MV
    from spark_rapids_tpu_torch.utils import profile as P
    from spark_rapids_tpu_torch.utils import residency as RES

    stage = exec_.stage
    if any(_reads_task_context(e) for e in stage.out_exprs + stage.preds):
        raise SpmdUnsupported(
            "the stage reads the task context (partition id, row offset "
            "or input file), which a flattened gang does not carry per "
            "slot")
    schema = stage.in_schema
    n_dev = mesh.shape[axis]
    B = len(batches)
    n_slots = -(-B // n_dev) * n_dev
    per_slot = n_slots // n_dev
    cap, char_caps = _gang_layout(schema, batches)
    home = mesh.home
    # gang slot s lives on mesh slot s // per_slot (the reference's
    # leading-axis sharding), so each device takes contiguous runs
    members: dict = {}
    for s in range(B):
        members.setdefault(mesh.devices[s // per_slot], []).append(s)
    stacks = [(dev, slots, _stack_gang(schema, [batches[s] for s in slots],
                                       cap, char_caps, dev))
              for dev, slots in members.items()]
    est_bytes = sum(_nbytes(_vector_tensors(cols) + [masks])
                    for _, _, (cols, masks) in stacks)
    has_filter = bool(stage.preds)
    out_schema = exec_.output_schema()

    def dispatch():
        results = []
        for dev, slots, (cols, masks) in stacks:
            k = len(slots)
            flat = [ColumnVector(c.dtype, _flat(c.data), _flat(c.validity),
                                 _flat(c.narrow), _flat(c.lengths))
                    for c in cols]
            mask = masks.reshape(-1)
            with exec_.kp_step("spmd-gang", k, cap, device=dev,
                               members=stage.member_names()) as kw:
                ctx = make_eval_context(flat, k * cap,
                                        mask.sum().to(torch.int32), mask)
                out_cols, keep = _eval_stage(stage, ctx)
                counts = keep.view(k, cap).sum(1).to(torch.int32)
                if kw.wants_cost():
                    kw.cost(flat, out_cols, keep)
            results.append((dev, slots, out_cols, keep, counts,
                            _register_ansi(ctx)))
        return results

    first = not getattr(exec_, "_spmd_reported", False)
    t0 = time.perf_counter()
    # one task hold covers the whole mesh: the gang is the stage's
    # occupancy of every slot
    TpuSemaphore.get().acquire_if_necessary()
    with RES.tracked(est_bytes, site="spmd-gang", kind=RES.KIND_GANG), \
            S.whole_mesh_dispatch(label=stage.describe_ops()):
        t_disp = time.perf_counter_ns()
        results = R.with_retry(
            lambda: watched_collective(
                dispatch, label=f"spmd:{stage.describe_ops()}"),
            out_bytes=est_bytes, metrics=exec_.metrics,
            label=f"SpmdStage[{stage.describe_ops()}]", device=home)
        outs: list = [None] * B
        out_tensors: list = []
        for dev, slots, out_cols, keep, counts, checks in results:
            k = len(slots)
            out_tensors += _vector_tensors(out_cols) + [keep, counts]
            slot_keep = keep.view(k, cap).to(home, non_blocking=True)
            slot_counts = counts.to(home, non_blocking=True)
            for j, s in enumerate(slots):
                b = batches[s]
                slot_cols = [ColumnVector(
                    f.dtype, _slot(c.data, k, cap, j, home),
                    _slot(c.validity, k, cap, j, home),
                    _slot(c.narrow, k, cap, j, home),
                    _slot(c.lengths, k, cap, j, home))
                    for f, c in zip(out_schema.fields, out_cols)]
                b_checks = b.checks + checks
                if has_filter:
                    outs[s] = ColumnarBatch(out_schema, slot_cols,
                                            slot_counts[j], b_checks,
                                            sparse=slot_keep[j])
                elif b.sparse is not None:
                    outs[s] = ColumnarBatch(out_schema, slot_cols, b._rows,
                                            b_checks, sparse=slot_keep[j])
                else:
                    outs[s] = ColumnarBatch(out_schema, slot_cols, b._rows,
                                            b_checks)
        disp_ns = time.perf_counter_ns() - t_disp
    exec_._spmd_reported = True
    P.event(P.EV_STAGE_SPMD, members=stage.member_names(), batches=B,
            slots=n_slots, mesh_devices=int(n_dev),
            **({"first_dispatch_ms": round((time.perf_counter() - t0)
                                           * 1e3, 2)} if first else {}))
    _bump(gang_dispatches=1, gang_batches=B, gang_slots=n_slots)
    exec_.metrics.add(M.NUM_SPMD_DISPATCHES, 1)
    if n_dev > 1 and MV.ledger() is not None:
        # the gang's outputs entering the gather to the home device, in
        # the exchange lane's bytes-entering-the-collective convention
        implicit = _nbytes(out_tensors)
        MV.record(MV.EDGE_COLLECTIVE, implicit, site=SITE_SPMD_STAGE,
                  dur_ns=disp_ns)
        exec_.metrics.add(M.COLLECTIVE_BYTES, implicit)
    rows = [r[4].sum() for r in results]
    exec_.metrics.add(M.NUM_OUTPUT_ROWS, sum(r.to(home) for r in rows))
    exec_.metrics.add(M.NUM_OUTPUT_BATCHES, B)
    return outs
