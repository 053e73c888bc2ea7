"""Device-memory (HBM) residency ledger: per-buffer provenance,
per-query high-water marks, and leak detection (port of
spark_rapids_tpu/utils/residency.py).

The movement ledger (utils/movement.py) counts bytes crossing edges, the
utilization sampler (utils/telemetry.py) names idle causes, kernelprof
(utils/kernelprof.py) names kernels; this module accounts for *stock*:
which query and which operator site owns each device byte at any
instant, and what a plan shape actually peaks at.

Two pieces:

* **Process-wide provenance registry** — every device-resident
  allocation the engine tracks registers a `ProvenanceRecord` on
  creation and retires it on free/spill: tiered-store buffers
  (`memory/stores.py` `_track`/`remove`, which covers the shuffle
  catalog's map-output and received buffers) and OOM-harness
  reservations (`memory/retry.py`, carrying the exec's label).  Each
  record carries the owning query id, the provenance *site* (operator /
  subsystem), size, storage tier, kind, and birth time — so at any
  instant the engine answers "who holds device memory and why" WITHOUT
  touching the device.  Surfaced through telemetry gauges
  (`hbm_resident_bytes{tier}`, per-site bytes), the `/telemetry` JSON
  view, and a `-- residency --` holder table in the watchdog dump.
* **QueryResidencyLedger** — one per profiled query, riding the
  QueryTracer like the movement and kernel ledgers: live
  device-resident bytes by (site, tier), the query's high-water mark
  with the peak instant's composition, a bounded residency timeline
  (Perfetto ``residency:<site>`` counter tracks), and a leak check at
  query end — records still attributed to a finished query are
  flagged, counted, and dumped with provenance.  The slow-query log
  aggregates observed high-water marks per plan fingerprint
  (p50/p95/max), the feed learned admission budgets would consume.

Discipline (the profiler's): DISABLED (default) every hook is one
module-global read — `track()` returns None and allocates nothing, so
the hot path is bit-identical.  Enabling is process-sticky (triggered
by the first profiled query whose conf sets
`spark.rapids.sql.profile.residency.enabled`, the kernelprof pattern):
tracked coverage starts at that point, which is why reports speak of
reconciliation "within tracked-allocation coverage".
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Optional

# -- storage tiers / record kinds ---------------------------------------------
TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"

#: a tiered-store buffer (memory/stores.py — includes shuffle catalog
#: buffers, which ride the same stores)
KIND_STORE = "store"
#: an OOM-harness output reservation (memory/retry.py)
KIND_RESERVATION = "reservation"
#: the stacked inputs of one SPMD gang dispatch (exec/spmd.py)
KIND_GANG = "gang"

#: bound on leaked-record provenance lines a dump/report renders
DEFAULT_LEAK_DUMP = 8

# -- module state: ONE global read (`_ENABLED`) gates every hook --------------
_ENABLED = False
_LOCK = threading.Lock()
#: token -> live ProvenanceRecord (the process-wide holder table)
_LIVE: dict[int, "ProvenanceRecord"] = {}
_TOKENS = itertools.count(1)
#: records flagged still-live at their owning query's end, process-wide
_LEAKS_TOTAL = [0]

#: thread-local provenance overrides: `site_scope` names the site for
#: registrations made below it (shuffle write/recv paths), and
#: `inherit_scope` carries a spilling buffer's ORIGINAL owner across
#: the tier copy so a pressure spill triggered by query B never
#: re-attributes query A's bytes.
_TLS = threading.local()


def enabled() -> bool:
    """The disabled-path gate: one module-global read."""
    return _ENABLED


def maybe_enable(conf=None) -> bool:
    """Sticky process-wide enable, driven by the first profiled query
    whose conf sets spark.rapids.sql.profile.residency.enabled (the
    kernelprof pattern).  One conf lookup when off."""
    from spark_rapids_tpu_torch import config as C
    conf = conf if conf is not None else C.get_active_conf()
    if not conf[C.RESIDENCY_ENABLED]:
        return _ENABLED
    enable()
    return True


def enable() -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = True


def disable() -> None:
    """Stop registering NEW allocations.  Live records keep retiring
    normally (their tokens are already attached to their buffers)."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False


def reset() -> None:
    """Tests: disable and drop every live record + the leak counter."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
        _LIVE.clear()
        _LEAKS_TOTAL[0] = 0


# ---------------------------------------------------------------------------
class ProvenanceRecord:
    """One live tracked allocation: who holds it and why."""

    __slots__ = ("token", "query_id", "site", "size_bytes", "tier",
                 "kind", "birth", "leaked", "ledger")

    def __init__(self, token: int, query_id: Optional[str], site: str,
                 size_bytes: int, tier: str, kind: str, ledger):
        self.token = token
        self.query_id = query_id
        self.site = site
        self.size_bytes = size_bytes
        self.tier = tier
        self.kind = kind
        self.birth = time.time()
        self.leaked = False
        #: the owning query's QueryResidencyLedger (None when the
        #: allocation happened outside a profiled query) — frees
        #: resolve THIS ledger, not the freeing thread's, so a
        #: cross-query spill/free never mis-charges
        self.ledger = ledger

    def snapshot(self) -> dict:
        return {"site": self.site, "tier": self.tier, "kind": self.kind,
                "bytes": self.size_bytes,
                "query_id": self.query_id or "?",
                "age_s": round(time.time() - self.birth, 3)}


# ---------------------------------------------------------------------------
@contextmanager
def site_scope(site: str):
    """Name the provenance site for registrations made on this thread
    below this scope (shuffle write/receive paths, which add buffers
    through the generic store API)."""
    prev = getattr(_TLS, "site", None)
    _TLS.site = site
    try:
        yield
    finally:
        _TLS.site = prev


@contextmanager
def inherit_scope(token: Optional[int]):
    """Carry the provenance (owner query + site) of an existing record
    onto registrations made below — the spill path wraps the tier copy
    in this so the host/disk copy of query A's buffer stays attributed
    to query A even when query B's pressure triggered the spill."""
    rec = None
    if token is not None:
        with _LOCK:
            rec = _LIVE.get(token)
    if rec is None:
        yield
        return
    prev = getattr(_TLS, "inherit", None)
    _TLS.inherit = rec
    try:
        yield
    finally:
        _TLS.inherit = prev


def current_site() -> Optional[str]:
    return getattr(_TLS, "site", None)


def buffer_site(bid) -> str:
    """Default site for a tiered-store buffer: the thread's
    `site_scope` when set, else derived from the BufferId's shuffle
    coordinates."""
    site = getattr(_TLS, "site", None)
    if site is not None:
        return site
    if getattr(bid, "shuffle_id", -1) >= 0:
        return "shuffle-map"
    return "store"


# ---------------------------------------------------------------------------
def track(nbytes: int, site: str, tier: str = TIER_DEVICE,
          kind: str = KIND_STORE) -> Optional[int]:
    """Register one tracked allocation; returns the retire token, or
    None when residency tracking is off (one global read, nothing
    allocated) or the size is degenerate.  Attribution: the calling
    thread's profiled query (via the profiler's per-query resolution),
    unless an `inherit_scope` carries another record's owner."""
    if not _ENABLED:
        return None
    nbytes = int(nbytes)
    if nbytes <= 0:
        return None
    inherit = getattr(_TLS, "inherit", None)
    if inherit is not None:
        query_id, ledger = inherit.query_id, inherit.ledger
        site = inherit.site
    else:
        from spark_rapids_tpu_torch.utils import profile as P
        tr = P.tracer()
        ledger = getattr(tr, "residency", None) if tr is not None \
            else None
        query_id = tr.query_id if tr is not None else None
    with _LOCK:
        token = next(_TOKENS)
        rec = _LIVE[token] = ProvenanceRecord(
            token, query_id, site, nbytes, tier, kind, ledger)
    if ledger is not None:
        ledger.on_alloc(rec)
    return token


def retire(token: Optional[int]) -> None:
    """Retire a tracked allocation (free / tier exit).  None and
    already-retired tokens are no-ops, so callers never need to guard."""
    if token is None:
        return
    with _LOCK:
        rec = _LIVE.pop(token, None)
    if rec is None:
        return
    if rec.ledger is not None:
        rec.ledger.on_free(rec)


@contextmanager
def tracked(nbytes: int, site: str, tier: str = TIER_DEVICE,
            kind: str = KIND_STORE):
    """Scope-shaped track/retire for allocations whose lifetime IS a
    code region.  A no-op shell when tracking is off."""
    token = track(nbytes, site, tier=tier, kind=kind)
    try:
        yield token
    finally:
        retire(token)


def lookup(token: Optional[int]) -> Optional[dict]:
    """Snapshot of one live record (diagnostics)."""
    if token is None:
        return None
    with _LOCK:
        rec = _LIVE.get(token)
    return rec.snapshot() if rec is not None else None


# -- process-wide views (telemetry gauges / watchdog dump / tests) ------------
def resident_bytes(tier: Optional[str] = None) -> int:
    """Total tracked live bytes, optionally restricted to one tier."""
    with _LOCK:
        return sum(r.size_bytes for r in _LIVE.values()
                   if tier is None or r.tier == tier)


def by_tier() -> dict:
    """{tier: live tracked bytes} — the hbm_resident_bytes{tier}
    gauge's source."""
    out: dict = {}
    with _LOCK:
        for r in _LIVE.values():
            out[r.tier] = out.get(r.tier, 0) + r.size_bytes
    return out


def by_site(tier: Optional[str] = None) -> dict:
    """{site: live tracked bytes}, device tier by default-none=all."""
    out: dict = {}
    with _LOCK:
        for r in _LIVE.values():
            if tier is not None and r.tier != tier:
                continue
            out[r.site] = out.get(r.site, 0) + r.size_bytes
    return out


def holders(limit: int = 16) -> list:
    """The holder table: live bytes aggregated by (query, site, tier,
    kind), largest first — who holds HBM and why, right now."""
    agg: dict = {}
    with _LOCK:
        for r in _LIVE.values():
            key = (r.query_id or "?", r.site, r.tier, r.kind)
            st = agg.get(key)
            if st is None:
                st = agg[key] = [0, 0, r.birth]
            st[0] += r.size_bytes
            st[1] += 1
            st[2] = min(st[2], r.birth)
    now = time.time()
    rows = [{"query_id": q, "site": s, "tier": t, "kind": k,
             "bytes": b, "buffers": n,
             "oldest_age_s": round(now - birth, 1)}
            for (q, s, t, k), (b, n, birth) in agg.items()]
    rows.sort(key=lambda r: r["bytes"], reverse=True)
    return rows[:limit]


def live_records_for_query(query_id: str) -> list:
    """Snapshots of every live record attributed to `query_id` — the
    leak check's input, and a test probe."""
    with _LOCK:
        return [r.snapshot() for r in _LIVE.values()
                if r.query_id == query_id]


def leaks_total() -> int:
    """Records flagged still-live at their query's end since process
    start (or the last reset) — the residency_leaks_total gauge."""
    with _LOCK:
        return _LEAKS_TOTAL[0]


def _flag_leaks(query_id: str) -> list:
    """Mark every live record of `query_id` leaked; returns their
    snapshots.  Records stay in the registry — they ARE still resident
    and the watchdog holder table should keep showing them."""
    with _LOCK:
        leaked = [r for r in _LIVE.values()
                  if r.query_id == query_id and not r.leaked]
        for r in leaked:
            r.leaked = True
        _LEAKS_TOTAL[0] += len(leaked)
    return [r.snapshot() for r in leaked]


def describe_for_dump(limit: int = 12) -> str:
    """Multi-line holder table for the watchdog dump."""
    if not _ENABLED:
        return "  <residency tracking off>"
    tiers = by_tier()
    lines = ["  tracked resident: "
             + (" ".join(f"{t}={b / 1e6:.1f}MB"
                         for t, b in sorted(tiers.items()))
                or "(nothing tracked)")
             + f"  leaks_total={leaks_total()}"]
    for h in holders(limit):
        lines.append(
            f"  {h['bytes'] / 1e6:10.2f} MB  x{h['buffers']:<4d} "
            f"{h['tier']:6s} {h['kind']:11s} {h['site']:20s} "
            f"query={h['query_id']}  oldest={h['oldest_age_s']}s")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
class QueryResidencyLedger:
    """Per-query residency accounting (created on the QueryTracer like
    the movement and kernel ledgers): live device-resident bytes by
    (site, tier), the HBM high-water mark with its peak-instant
    composition, a bounded timeline for the Perfetto counter tracks,
    and the end-of-query leak verdict."""

    def __init__(self, query_id: str, t_origin: int,
                 timeline: int = 4096,
                 leak_dump: int = DEFAULT_LEAK_DUMP):
        self.query_id = query_id
        self.t_origin = t_origin
        self.leak_dump = max(0, int(leak_dump))
        self._lock = threading.Lock()
        #: (site, tier) -> [live_bytes, cumulative_allocs]
        self._sites: dict[tuple, list] = {}
        #: live DEVICE-tier bytes (what counts against HBM)
        self._live = 0
        self.hbm_high_water = 0
        #: {(site, tier): bytes} snapshot at the high-water instant
        self._peak_composition: dict = {}
        self._peak_ts = 0
        #: (ts_ns, site, site_live_bytes, total_device_live) samples
        self._samples: "collections.deque[tuple]" = \
            collections.deque(maxlen=max(16, int(timeline)))
        self.allocs = 0
        self.frees = 0
        #: leak snapshots, filled by finalize()
        self.leaks: list = []

    # -- recording (called by the process registry) ---------------------------
    def on_alloc(self, rec: ProvenanceRecord) -> None:
        ts = time.perf_counter_ns() - self.t_origin
        key = (rec.site, rec.tier)
        with self._lock:
            st = self._sites.get(key)
            if st is None:
                st = self._sites[key] = [0, 0]
            st[0] += rec.size_bytes
            st[1] += 1
            self.allocs += 1
            if rec.tier == TIER_DEVICE:
                self._live += rec.size_bytes
                if self._live > self.hbm_high_water:
                    self.hbm_high_water = self._live
                    # the peak instant's DEVICE composition: its site
                    # bytes sum exactly to the high-water mark (small
                    # dict; high-water updates are rare past warmup)
                    self._peak_composition = {
                        k: v[0] for k, v in self._sites.items()
                        if v[0] and k[1] == TIER_DEVICE}
                    self._peak_ts = ts
            self._samples.append((ts, rec.site, st[0], self._live))

    def on_free(self, rec: ProvenanceRecord) -> None:
        ts = time.perf_counter_ns() - self.t_origin
        key = (rec.site, rec.tier)
        with self._lock:
            st = self._sites.get(key)
            if st is not None:
                st[0] = max(0, st[0] - rec.size_bytes)
            self.frees += 1
            if rec.tier == TIER_DEVICE:
                self._live = max(0, self._live - rec.size_bytes)
            self._samples.append(
                (ts, rec.site, st[0] if st is not None else 0,
                 self._live))

    # -- views ---------------------------------------------------------------
    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._live

    def samples(self) -> list:
        with self._lock:
            return list(self._samples)

    def finalize(self) -> list:
        """End-of-query leak check: flag every process-registry record
        still attributed to this query.  Returns (and remembers) their
        provenance snapshots."""
        self.leaks = _flag_leaks(self.query_id)
        return self.leaks

    def report(self) -> dict:
        """The residency report QueryProfile embeds."""
        with self._lock:
            sites = {f"{site}|{tier}": {"live_bytes": st[0],
                                        "allocs": st[1]}
                     for (site, tier), st in self._sites.items()}
            peak = {f"{site}|{tier}": b
                    for (site, tier), b in self._peak_composition.items()}
            return {
                "hbm_high_water": self.hbm_high_water,
                "peak_ts_ns": self._peak_ts,
                "peak_composition": peak,
                "live_end_bytes": self._live,
                "allocs": self.allocs,
                "frees": self.frees,
                "leaks": len(self.leaks),
                "leaked": list(self.leaks[:self.leak_dump]),
            }


def format_report(rep: Optional[dict]) -> str:
    """Human-facing rendering of a residency report (the
    '-- residency --' section QueryProfile.explain appends)."""
    if not rep:
        return "<no residency tracked>"
    lines = [f"hbm high water: {rep['hbm_high_water'] / 1e6:.2f} MB "
             f"at t+{rep['peak_ts_ns'] / 1e6:.1f} ms  "
             f"(allocs {rep['allocs']}, frees {rep['frees']}, "
             f"live at end {rep['live_end_bytes'] / 1e6:.2f} MB)"]
    comp = rep.get("peak_composition") or {}
    for key, b in sorted(comp.items(), key=lambda kv: -kv[1]):
        site, _, tier = key.partition("|")
        lines.append(f"  at peak  {site:24s} [{tier}] "
                     f"{b / 1e6:10.2f} MB")
    n = rep.get("leaks", 0)
    if n:
        lines.append(f"leak verdict: {n} buffer(s) still resident at "
                     "query end")
        for rec in rep.get("leaked", []):
            lines.append(
                f"  LEAKED {rec['bytes'] / 1e6:.2f} MB  {rec['site']} "
                f"[{rec['tier']}/{rec['kind']}] age {rec['age_s']}s")
    else:
        lines.append("leak verdict: clean (0 buffers resident at "
                     "query end)")
    return "\n".join(lines)
