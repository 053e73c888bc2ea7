"""Out-of-core execution support: spilled runs + the degradation decision
(port of spark_rapids_tpu/memory/oocore.py).

Bounded device-memory graceful degradation: when an operator's
working set cannot fit the conf-capped HBM budget
(`spark.rapids.memory.hbmBudgetBytes`), sort / hash join / hash aggregate
stop split-retrying toward the `minSplitRows` floor and switch to external
algorithms that stream state through the existing device→host→disk spill
tiers.  This module is the shared substrate those three lanes use:

- `should_go_external(est_bytes)` — the degradation decision, driven by
  real accounting: the per-operator window (`oocore.windowFraction` of
  `DeviceManager.budget`) plus a live `try_reserve` probe, never a guess.
- `spill_run(batch)` / `SpilledRun.read()` — one unit of spilled operator
  state (a sorted run, a grace-hash partition piece, a merged partial-agg
  block), serialized and pushed down the host→disk chain with optional
  replicas.
- Corruption recovery: a `SpillCorruption` on re-read quarantines the
  poisoned file (logged), falls back to a replica if one was
  written, else to a bounded recompute closure if the producer supplied
  one — and only then fails, descriptively (satellite: a corrupt spill
  re-read must not kill the query when a recovery path exists).

The reference stack's analog rails are RapidsBufferStore spill chaining +
RmmRapidsRetryIterator; here out-of-core is the OUTER ring around the OOM
split-retry lattice — retry shrinks batches inside the window, oocore
bounds how much state is in the window at all.  Not ported yet: the
movement ledger's spill edges and the profile's out-of-core events.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.serde import (deserialize_batch,
                                                   serialize_batch)
from spark_rapids_tpu_torch.memory.buffer import BufferId, TableMeta
from spark_rapids_tpu_torch.memory.stores import SpillCorruption
from spark_rapids_tpu_torch.utils import metrics as M
from spark_rapids_tpu_torch.utils import movement as MV
from spark_rapids_tpu_torch.utils import profile as P

#: movement-ledger site prefix of out-of-core run spills
SITE_PREFIX = "oocore:"

log = logging.getLogger("spark_rapids_tpu_torch.oocore")

#: external-sort merge fan-in target: runs flush at window/MERGE_FAN_IN
#: so one merge group of this many runs fits back inside the window —
#: maxRecursionDepth merge passes then cover MERGE_FAN_IN**depth runs
MERGE_FAN_IN = 8

# process-wide run accounting (the SpillCallback.bytes_spilled analog
# for the out-of-core lane): equals the per-node spillRunBytes sums
_ACCT_LOCK = threading.Lock()
_RUN_BYTES = [0]
_RUN_COUNT = [0]


def reset_run_accounting() -> None:
    with _ACCT_LOCK:
        _RUN_BYTES[0] = 0
        _RUN_COUNT[0] = 0


def run_bytes_spilled() -> int:
    """Serialized bytes written as out-of-core runs process-wide
    (replica copies included) since the last reset."""
    with _ACCT_LOCK:
        return _RUN_BYTES[0]


def runs_spilled() -> int:
    with _ACCT_LOCK:
        return _RUN_COUNT[0]


# ---------------------------------------------------------------------------
# degradation decision
def window_bytes(conf: Optional[C.RapidsConf] = None,
                 dm=None) -> int:
    """Bytes one operator may hold on the device at a time: the window
    external sort/join/agg size their runs, merge fan-ins, and grace
    partitions against."""
    conf = conf or C.get_active_conf()
    if dm is None:
        from spark_rapids_tpu_torch.memory.device_manager import \
            DeviceManager
        dm = DeviceManager.peek()
    if dm is None:
        return 1 << 62  # no device manager: effectively unbounded
    frac = float(conf[C.OOCORE_WINDOW_FRACTION])
    return max(1, int(dm.budget * frac))


def should_go_external(est_bytes: int,
                       conf: Optional[C.RapidsConf] = None,
                       dm=None) -> bool:
    """The degradation decision.  True when `est_bytes` of operator
    working set should stream through the spill tiers instead of
    materializing on the device.  Two gates, both from real accounting:

    1. the estimate exceeds the per-operator window (windowFraction of
       the conf-capped `DeviceManager.budget`), and
    2. a live `try_reserve` probe confirms the arena really has no
       headroom for it right now — a generous arena with idle budget
       does not degrade on a pessimistic estimate.
    """
    conf = conf or C.get_active_conf()
    if not bool(conf[C.OOCORE_ENABLED]):
        return False
    if dm is None:
        from spark_rapids_tpu_torch.memory.device_manager import \
            DeviceManager
        dm = DeviceManager.peek()
    if dm is None:
        return False
    if est_bytes <= window_bytes(conf, dm):
        return False
    if dm.try_reserve(est_bytes):
        dm.release_reservation(est_bytes)
        return False
    return True


# ---------------------------------------------------------------------------
# spilled runs
class SpilledRun:
    """Handle to one unit of spilled operator state: the primary copy
    plus any replicas, all registered in the buffer catalog and resident
    at whatever tier (host arena, falling through to disk) took them."""

    __slots__ = ("bids", "meta", "nbytes", "num_rows", "label",
                 "recompute", "_freed")

    def __init__(self, bids: list[BufferId], meta: TableMeta, nbytes: int,
                 num_rows: int, label: str,
                 recompute: Optional[Callable[[], ColumnarBatch]]):
        self.bids = bids
        self.meta = meta
        #: serialized size of ONE copy (what a merge window budgets for)
        self.nbytes = nbytes
        self.num_rows = num_rows
        self.label = label
        self.recompute = recompute
        self._freed = False

    def read(self, metrics=None) -> ColumnarBatch:
        """Materialize the run back to a device batch, recovering from
        spill corruption via replicas / recompute (see module doc)."""
        from spark_rapids_tpu_torch.memory.env import ResourceEnv
        env = ResourceEnv.get()
        corrupt = 0
        for i, bid in enumerate(self.bids):
            if not env.catalog.is_registered(bid):
                continue  # quarantined by an earlier read of this run
            try:
                with env.catalog.acquired(bid) as buf:
                    batch = buf.get_columnar_batch()
                if corrupt and metrics is not None:
                    metrics.add(M.NUM_SPILL_CORRUPTIONS_RECOVERED, 1)
                if corrupt:
                    P.event(P.EV_OOCORE_CORRUPT_RECOVERED,
                            op=self.label, via=f"replica{i}")
                return batch
            except SpillCorruption as e:
                corrupt += 1
                self._quarantine(env, bid, e)
        if self.recompute is not None:
            batch = self.recompute()
            if corrupt:
                if metrics is not None:
                    metrics.add(M.NUM_SPILL_CORRUPTIONS_RECOVERED, 1)
                P.event(P.EV_OOCORE_CORRUPT_RECOVERED,
                        op=self.label, via="recompute")
            return batch
        raise SpillCorruption(
            f"out-of-core run {self.label} ({self.num_rows} rows, "
            f"{self.nbytes} bytes) unreadable: all {len(self.bids)} "
            f"cop{'ies' if len(self.bids) > 1 else 'y'} failed CRC "
            f"verification and no recompute lineage is available — "
            f"raise spark.rapids.memory.oocore.runReplicas to keep a "
            f"redundant copy of spilled runs")

    def _quarantine(self, env, bid: BufferId, err: Exception) -> None:
        """Logged quarantine of a corrupt copy: the poisoned file is set
        aside (never unlinked, never re-readable) and the buffer leaves
        the catalog."""
        from spark_rapids_tpu_torch.utils import residency as RES
        site = RES.buffer_site(bid)
        qpath = None
        if hasattr(env.disk_store, "quarantine"):
            qpath = env.disk_store.quarantine(bid)
        if qpath is None:
            env.catalog.remove(bid)  # not at disk tier: just drop it
        log.warning(
            "quarantined corrupt spill of out-of-core run %s "
            "(buffer %s, provenance %s) at %s: %s", self.label, bid, site,
            qpath, err)
        P.event(P.EV_OOCORE_CORRUPT_QUARANTINE, op=self.label,
                site=site, path=str(qpath))

    def free(self) -> None:
        """Drop every copy from whatever tier holds it (and its spill
        file, for disk-resident copies)."""
        if self._freed:
            return
        self._freed = True
        from spark_rapids_tpu_torch.memory.env import ResourceEnv
        env = ResourceEnv.peek()
        if env is None:
            return
        for bid in self.bids:
            env.catalog.remove(bid)


def spill_run(batch: ColumnarBatch, *, label: str, metrics=None,
              conf: Optional[C.RapidsConf] = None,
              recompute: Optional[Callable[[], ColumnarBatch]] = None
              ) -> SpilledRun:
    """Serialize `batch` and push it down the host→disk spill chain as
    one out-of-core run (plus `oocore.runReplicas - 1` replica copies),
    charging the exec's `spillRunBytes`.  Records one movement-ledger
    spill edge per copy (site `oocore:device->host|disk`).  The
    environment is made on the batch's device if there is none yet.
    """
    import time
    from spark_rapids_tpu_torch.memory.buffer import meta_for_batch
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    conf = conf or C.get_active_conf()
    env = ResourceEnv.get(batch.device)
    blob = serialize_batch(batch)
    meta = meta_for_batch(batch)
    copies = max(1, int(conf[C.OOCORE_RUN_REPLICAS]))
    bids = []
    for _ in range(copies):
        bid = BufferId(env.catalog.next_table_id())
        t0 = time.perf_counter_ns()
        # spill_priority 0 keeps runs ahead of hot shuffle buffers in
        # the host arena's eviction order — they are cold by design
        buf = env.host_store.add_blob(bid, blob, meta, spill_priority=0.0)
        # add_blob records no ledger edge (shuffle receives reuse it); an
        # out-of-core run IS a spill hop: record the one that happened
        if MV.ledger() is not None:
            MV.record(MV.EDGE_SPILL, len(blob),
                      site=f"{SITE_PREFIX}device->{buf.tier.name.lower()}",
                      raw_bytes=len(blob),
                      dur_ns=time.perf_counter_ns() - t0)
        bids.append(bid)
        with _ACCT_LOCK:
            _RUN_BYTES[0] += len(blob)
            _RUN_COUNT[0] += 1
        if metrics is not None:
            metrics.add(M.SPILL_RUN_BYTES, len(blob))
    P.event(P.EV_OOCORE_SPILL_RUN, op=label, nbytes=len(blob) * copies,
            rows=batch.num_rows, copies=copies)
    return SpilledRun(bids, meta, len(blob), batch.num_rows, label,
                      recompute)


def merge_groups(runs: list, window: int) -> list[list]:
    """Runs grouped for one merge pass: each group's runs, at twice
    their serialized size (payload plus sort scratch), fit `window`,
    and every group takes at least 2 runs, so each pass at least halves
    the run count (the inner split-retry lattice absorbs an
    overshoot)."""
    groups: list[list] = [[]]
    group_bytes = 0
    for r in runs:
        if len(groups[-1]) >= 2 and group_bytes + 2 * r.nbytes > window:
            groups.append([])
            group_bytes = 0
        groups[-1].append(r)
        group_bytes += 2 * r.nbytes
    return groups


def merge_spilled(runs: list, merge: Callable[[list], ColumnarBatch], *,
                  label: str, what: str, metrics=None,
                  conf: Optional[C.RapidsConf] = None) -> ColumnarBatch:
    """Hierarchical merge of spilled runs: each pass reads back
    window-sized groups, merges each with `merge(batches)` (the OOM
    split-retry lattice stays active inside) and re-spills, until one
    run remains.  Bounded by `oocore.maxRecursionDepth` passes — past
    it, a descriptive error naming `what`, never a hang or partial
    data.  Runs it reads are freed here; `runs`, updated in place, is
    the caller's to free on error."""
    from spark_rapids_tpu_torch.memory.retry import TpuOutOfCoreError
    from spark_rapids_tpu_torch.utils import watchdog as W
    conf = conf or C.get_active_conf()
    window = window_bytes(conf)
    max_passes = max(1, int(conf[C.OOCORE_MAX_RECURSION]))
    passes = 0
    # the merge passes are watched: a group that makes no progress past
    # the task deadline cancels the query with a dump
    with W.heartbeat(f"{label}.oocore-merge", kind="task", conf=conf) as hb:
        while len(runs) > 1:
            if passes >= max_passes:
                raise TpuOutOfCoreError(
                    f"{label}: {what} still spans {len(runs)} runs after "
                    f"{passes} merge passes (spark.rapids.memory.oocore."
                    f"maxRecursionDepth={max_passes}) — the merge window "
                    f"({window} bytes) is too small for the run count; "
                    f"raise the device memory budget or "
                    f"oocore.windowFraction")
            passes += 1
            if metrics is not None:
                metrics.add(M.NUM_EXTERNAL_MERGE_PASSES, 1)
            P.event(P.EV_OOCORE_MERGE_PASS, op=label, num_runs=len(runs))
            groups = merge_groups(runs, window)
            next_runs = []
            for group in groups:
                W.maybe_hang("oocore-merge", conf)
                merged = merge([r.read(metrics) for r in group])
                for r in group:
                    r.free()
                hb.beat()
                if len(groups) == 1:
                    return merged  # final merge: no re-spill
                next_runs.append(spill_run(merged.dense(), label=label,
                                           metrics=metrics, conf=conf))
                runs.append(next_runs[-1])  # the caller frees on error
            runs[:] = next_runs
    batch = runs[0].read(metrics)
    runs[0].free()
    return batch


def read_run(run: SpilledRun, metrics=None) -> ColumnarBatch:
    return run.read(metrics)


__all__ = [
    "SpilledRun", "spill_run", "read_run", "merge_groups", "merge_spilled",
    "should_go_external",
    "window_bytes", "run_bytes_spilled", "runs_spilled",
    "reset_run_accounting", "deserialize_batch",
]
