"""Deferred device-side validity checks for optimistic fast paths (port of
spark_rapids_tpu/utils/checks.py).

A fast path (the dictionary group-by window, the banded lane's f32
exactness certificate) may produce results whose validity is only known
on the device as a bool scalar (True = INVALID).  Checks ride along until
the collect boundary, where `verify` reads them all back in one transfer.
On failure, `FastPathInvalid` carries recovery callbacks that disable the
fast paths at fault; `TpuExec.collect` recovers and re-executes the plan.

A check with an `error` factory is fatal: a failed one raises that
error (an ANSI cast's overflow) rather than FastPathInvalid.

Checks attach to batches (`ColumnarBatch.checks`) AND register in the
current query's pending list (`QueryContext.pending_checks`, shared by
the query's prefetch producers), so a check dropped from a batch's tuple
still fails safe at the next collect.  Work outside any query registers
in one process-global list.

The host-sync counter (`note_host_sync`) is the audit instrument of the
reference's pipelining work: every blocking device->host readback on
the hot path names its site, so how often the host waits on the device
is a number a run can print and diff, and a site that knows its bytes
feeds the current query's data-movement ledger (readback edge).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Optional

import torch

# ---------------------------------------------------------------------------
# host-sync counter: always on (a sync costs a device round trip; one
# guarded dict increment per sync is noise)
_SYNC_LOCK = threading.Lock()
_SYNC_SITES: "collections.Counter" = collections.Counter()
_SYNC_BYTES: "collections.Counter" = collections.Counter()


def note_host_sync(site: str = "?", nbytes: int = 0) -> None:
    """Record one device->host blocking readback attributed to `site`.
    `nbytes` (when the site knows it) feeds the per-site byte counter
    AND the current query's data-movement ledger (readback edge)."""
    with _SYNC_LOCK:
        _SYNC_SITES[site] += 1
        if nbytes:
            _SYNC_BYTES[site] += nbytes
    if nbytes:
        from spark_rapids_tpu_torch.utils import movement as MV
        led = MV.ledger()
        if led is not None:
            led.record(MV.EDGE_READBACK, nbytes, site=site)


def host_sync_count() -> int:
    with _SYNC_LOCK:
        return sum(_SYNC_SITES.values())


def host_sync_sites() -> dict:
    """Per-site sync counts (copy) — the audit view."""
    with _SYNC_LOCK:
        return dict(_SYNC_SITES)


def host_sync_bytes() -> dict:
    """Per-site readback byte counts for the sites that report them
    (copy) — the movement-ledger companion to host_sync_sites."""
    with _SYNC_LOCK:
        return dict(_SYNC_BYTES)


def reset_host_syncs() -> None:
    with _SYNC_LOCK:
        _SYNC_SITES.clear()
        _SYNC_BYTES.clear()


@dataclasses.dataclass(frozen=True, eq=False)
class BatchCheck:
    # eq=False: identity equality, so list membership never compares flags
    flag: object                      # device bool scalar; True = invalid
    origin: str                       # human-readable fast-path name
    recover: Optional[Callable] = None  # disables the fast path
    #: factory of a fatal error (an ANSI overflow): raised at once
    #: instead of the deopt-and-retry FastPathInvalid
    error: Optional[Callable] = None

    #: memoized verify outcome (a check may reach several verify
    #: boundaries; it is read back once)
    _resolved = None

    def _memoize(self, bad: bool) -> None:
        object.__setattr__(self, "_resolved", bool(bad))


class FastPathInvalid(Exception):
    def __init__(self, checks):
        self.checks = list(checks)
        super().__init__(
            "optimistic fast path produced invalid results: "
            + ", ".join(c.origin for c in self.checks))

    def recover_all(self) -> None:
        for c in self.checks:
            if c.recover is not None:
                c.recover()


_STATE = threading.local()
_LOCK = threading.Lock()
_PENDING: list = []


def _pending() -> list:
    """The deferred-check registry of the CURRENT query: each
    QueryContext owns its list, so one query's snapshot/drain never
    takes another's checks; the process-global list serves work outside
    any query."""
    from spark_rapids_tpu_torch.exec import scheduler as S
    qc = S.current()
    return qc.pending_checks if qc is not None else _PENDING


def set_retrying(flag: bool) -> None:
    """Marks the last deopt re-execution: optimistic fast paths whose
    recovery escalates a learned parameter must produce guaranteed-valid
    results then, and consult this to bypass themselves."""
    _STATE.retrying = flag


def is_retrying() -> bool:
    return getattr(_STATE, "retrying", False)


def register(check: BatchCheck) -> BatchCheck:
    with _LOCK:
        _pending().append(check)
    return check


def register_deopt(flag, origin: str, recover, checks: tuple) -> tuple:
    """Append a deferred deopt check to a batch's check tuple.  `flag`
    None means the fast lane was not taken — nothing to check."""
    if flag is None:
        return checks
    return checks + (register(BatchCheck(flag, origin, recover)),)


def verify(checks, scalars=()) -> list:
    """Resolve `checks` now (one device-to-host transfer for all of them
    and for `scalars`, extra device int scalars such as a lazy row
    count); raise FastPathInvalid on any failure.  Returns the scalars'
    host values in order."""
    checks = list(checks)
    items = [(i, c.flag) for i, c in enumerate(checks)
             if c._resolved is None]
    vals = [torch.as_tensor(f).reshape(()).to(torch.int64)
            for _, f in items]
    vals += [torch.as_tensor(s).reshape(()).to(torch.int64)
             for s in scalars]
    if vals:
        dev = vals[0].device
        note_host_sync("checks.verify", nbytes=8 * len(vals))
        host = torch.stack([v.to(dev) for v in vals]).cpu().tolist()
    else:
        host = []
    for (i, _), v in zip(items, host):
        checks[i]._memoize(v)
    scalar_vals = host[len(items):]
    with _LOCK:
        pending = _pending()
        for c in checks:
            try:
                pending.remove(c)
            except ValueError:
                pass
    bad = [c for c in checks if c._resolved]
    for c in bad:
        if c.error is not None:
            raise c.error()
    if bad:
        raise FastPathInvalid(bad)
    return scalar_vals


def snapshot() -> int:
    """Mark the registry position; checks registered after it belong to
    the enclosing execution attempt."""
    with _LOCK:
        return len(_pending())


def drain_since(mark: int) -> list:
    """Remove and return every check registered after `mark`."""
    with _LOCK:
        pending = _pending()
        out = pending[mark:]
        del pending[mark:]
    return out
