"""Per-query data-movement ledger: bytes on every edge (port of
spark_rapids_tpu/utils/movement.py).

Every site where bytes cross a boundary records (edge, site, bytes,
duration) into the query's DataMovementLedger, and the QueryProfile
renders the result as a movement report — per-edge byte totals,
effective GB/s vs a roofline, compression ratios, Chrome-trace counter
tracks, and event-log records.

Edge classes:

* ``upload``     — host -> device (H2D): batch construction from host
  data (`columnar/batch.py`, `plan/transitions.py`), scan uploads, and
  spill/shuffle re-uploads (`columnar/serde.py` deserialize).
* ``readback``   — device -> host (D2H): collect sinks
  (`to_pandas`, `plan/transitions.py df_from_batch`), spill/shuffle
  serialization, and every `utils/checks.py` `note_host_sync` site
  that knows its byte count (metric resolves, check waves, count
  syncs).
* ``spill``      — tier migrations in `memory/stores.py`: device->host,
  host->disk, and disk->host re-reads.  Each hop is a separate site so
  a device->host->disk migration is two records, never a double count;
  the ``device->host`` hop reconciles with the exec-level `spillBytes`
  metric and `SpillCallback.bytes_spilled`.
* ``wire``       — shuffle bytes crossing executor boundaries
  (`shuffle/client_server.py`, `shuffle/manager.py`): send and receive
  are distinct sites (``send:dcn`` / ``send:loop`` / ``recv``), and
  records carry BOTH compressed and uncompressed sizes so codec choice
  is visible.  Edge totals count the send side only — in-process runs
  see both directions in one ledger, and summing them would double the
  traffic.
* ``collective`` — payloads of the mesh lanes: a mesh exchange's
  stacked columns (site ``mesh-exchange``; its count phase, site
  ``mesh-count``, moves n ints and records nothing) and an SPMD gang's
  outputs (site ``spmd-stage``), in one convention
  (`parallel/collective_exchange.py stacked_payload_bytes`).  The bytes
  are the lane's logical payload: slots that share a card move them
  within its memory, not over an interconnect.

Discipline (the profiler's): with profiling disabled the hot path pays
ONE module-global read — `ledger()` resolves through
`profile.tracer()`, whose `_ACTIVE == 0` fast path allocates nothing.
Call sites that would compute a byte count first guard on
``ledger() is not None``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

# -- edge classes ------------------------------------------------------------
EDGE_UPLOAD = "upload"          # host -> device
EDGE_READBACK = "readback"      # device -> host
EDGE_SPILL = "spill"            # tier migrations (device/host/disk)
EDGE_WIRE = "wire"              # shuffle bytes between executors
EDGE_COLLECTIVE = "collective"  # multi-device collective payloads

EDGES = (EDGE_UPLOAD, EDGE_READBACK, EDGE_SPILL, EDGE_WIRE,
         EDGE_COLLECTIVE)

#: per-edge nominal bandwidth ceilings (GB/s) used when
#: spark.rapids.sql.profile.movement.rooflineGBps is 0: a VIEW of the
#: shared roofline table's registry defaults (utils/roofline.py), the
#: same source the per-kernel roofline join (utils/kernelprof.py) reads
from spark_rapids_tpu_torch.utils.roofline import \
    DEFAULT_EDGE_GBPS as NOMINAL_GBPS

#: bound on the Chrome-trace counter sample stream — enough resolution
#: for a long query's counter tracks, bounded against runaway loops
MAX_SAMPLES = 1 << 13

#: directions excluded from edge byte totals (receive-side mirrors of
#: bytes already counted at the sender — see module docstring)
_RECV_SITE_PREFIX = "recv"

#: wire-edge site for bytes a losing hedged fetch pulled before being
#: cancelled: the bytes really crossed the edge (they stay in the edge
#: total — hedging overhead is honest), but reclassified out of the
#: send:* sites so send:loop/send:dcn keep meaning "bytes the query
#: actually consumed"
SITE_WASTED = "wasted"


# process-lifetime cumulative edge totals across EVERY query's ledger
# (utils/telemetry.py movement_bytes_total gauge): per-query ledgers die
# with their profiles, but an operator watching a Prometheus scrape
# needs the fleet-wide trajectory.  Bumped inside record() — only while
# movement accounting is on, so the disabled path is untouched.
_PROC_LOCK = threading.Lock()
_PROC_EDGE_TOTALS: dict[str, int] = {}


def process_edge_totals() -> dict:
    """{edge: cumulative counted bytes} since process start (or the
    last reset)."""
    with _PROC_LOCK:
        return dict(_PROC_EDGE_TOTALS)


def reset_process_edge_totals() -> None:
    with _PROC_LOCK:
        _PROC_EDGE_TOTALS.clear()


class DataMovementLedger:
    """Byte accounting for one query.  Thread-safe; aggregation is a
    dict update per record, so the enabled path stays inside the
    profiler's <2% overhead budget."""

    def __init__(self, query_id: str, t_origin: int,
                 min_event_bytes: int = 1 << 16):
        self.query_id = query_id
        self.t_origin = t_origin
        self.min_event_bytes = int(min_event_bytes)
        #: (edge, site) -> [bytes, raw_bytes, count, dur_ns]
        self._stats: dict[tuple, list] = {}
        #: cumulative counted bytes per edge (send-direction only), for
        #: the Chrome counter tracks
        self._edge_cum: dict[str, int] = {}
        self._samples: "collections.deque[tuple]" = \
            collections.deque(maxlen=MAX_SAMPLES)
        self._lock = threading.Lock()
        #: back-reference set by the owning QueryTracer so big records
        #: land in the structured event log too
        self.tracer = None

    # -- recording -----------------------------------------------------------
    def record(self, edge: str, nbytes: int, site: str = "?",
               raw_bytes: Optional[int] = None, dur_ns: int = 0,
               **event_args) -> None:
        """Account `nbytes` moved across `edge` at `site`.  `raw_bytes`
        is the uncompressed size when the payload was codec-compressed
        (defaults to `nbytes`); `dur_ns` the synchronous wall time of
        the transfer when the caller measured one (0 = async/unknown).
        """
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        raw = int(raw_bytes) if raw_bytes is not None else nbytes
        ts = time.perf_counter_ns() - self.t_origin
        counted = not site.startswith(_RECV_SITE_PREFIX)
        with self._lock:
            st = self._stats.get((edge, site))
            if st is None:
                st = self._stats[(edge, site)] = [0, 0, 0, 0]
            st[0] += nbytes
            st[1] += raw
            st[2] += 1
            st[3] += int(dur_ns)
            if counted:
                cum = self._edge_cum.get(edge, 0) + nbytes
                self._edge_cum[edge] = cum
                self._samples.append((ts, edge, cum))
        if counted:
            with _PROC_LOCK:
                _PROC_EDGE_TOTALS[edge] = \
                    _PROC_EDGE_TOTALS.get(edge, 0) + nbytes
        tr = self.tracer
        if tr is not None and not tr.ended \
                and nbytes >= self.min_event_bytes:
            from spark_rapids_tpu_torch.utils.profile import EV_DATA_MOVEMENT
            tr.event(EV_DATA_MOVEMENT, edge=edge, site=site,
                     bytes=nbytes, raw_bytes=raw,
                     **({"dur_ns": int(dur_ns)} if dur_ns else {}),
                     **event_args)

    def move(self, edge: str, nbytes: int, from_site: str,
             to_site: str, raw_bytes: Optional[int] = None) -> None:
        """Reclassify already-recorded bytes from one site to another
        (losing hedged fetches: send:* -> wasted).  Counts and
        durations stay where they were measured; only bytes (and the
        raw mirror) migrate, clamped to what the source site actually
        holds so a racing record can never drive a site negative.
        Edge cumulative totals are unchanged — the bytes still crossed
        the edge."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        raw = int(raw_bytes) if raw_bytes is not None else nbytes
        with self._lock:
            src = self._stats.get((edge, from_site))
            if src is None:
                return
            nbytes = min(nbytes, src[0])
            raw = min(raw, src[1])
            if nbytes <= 0:
                return
            src[0] -= nbytes
            src[1] -= raw
            dst = self._stats.get((edge, to_site))
            if dst is None:
                dst = self._stats[(edge, to_site)] = [0, 0, 0, 0]
            dst[0] += nbytes
            dst[1] += raw
            dst[2] += 1

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """{edge: {site: {bytes, raw_bytes, count, dur_ns}}} copy."""
        with self._lock:
            out: dict = {}
            for (edge, site), (b, r, c, d) in self._stats.items():
                out.setdefault(edge, {})[site] = {
                    "bytes": b, "raw_bytes": r, "count": c, "dur_ns": d}
            return out

    def edge_bytes(self, edge: str, site_prefix: str = "") -> int:
        """Total bytes on `edge`, optionally restricted to sites with
        the given prefix.  Without a prefix, receive-side sites are
        excluded (they mirror bytes counted at the sender)."""
        with self._lock:
            total = 0
            for (e, site), st in self._stats.items():
                if e != edge:
                    continue
                if site_prefix:
                    if not site.startswith(site_prefix):
                        continue
                elif site.startswith(_RECV_SITE_PREFIX):
                    continue
                total += st[0]
            return total

    def samples(self) -> list[tuple]:
        with self._lock:
            return list(self._samples)

    # -- report --------------------------------------------------------------
    def report(self, wall_s: float,
               roofline_gbps: float = 0.0, conf=None) -> dict:
        """The movement report QueryProfile embeds: per-edge totals,
        effective GB/s (bytes / query wall clock — the achieved average
        rate), busy GB/s (bytes / measured transfer time, for edges
        whose records carry durations), utilization vs the roofline,
        and the per-site breakdown.  Ceilings resolve through the
        shared conf-overridable roofline table (utils/roofline.py):
        `roofline_gbps` (the legacy all-edges override) wins when
        non-zero, then the per-edge spark.rapids.sql.profile.roofline.*
        entries of `conf` (registry defaults when None)."""
        from spark_rapids_tpu_torch.utils import roofline as RL
        edge_roof = (dict(NOMINAL_GBPS) if conf is None
                     else RL.edge_table(conf))
        snap = self.snapshot()
        edges: dict = {}
        for edge in EDGES:
            sites = snap.get(edge, {})
            counted = {s: v for s, v in sites.items()
                       if not s.startswith(_RECV_SITE_PREFIX)}
            b = sum(v["bytes"] for v in counted.values())
            raw = sum(v["raw_bytes"] for v in counted.values())
            cnt = sum(v["count"] for v in counted.values())
            dur = sum(v["dur_ns"] for v in counted.values())
            roof = roofline_gbps or edge_roof[edge]
            avg = b / wall_s / 1e9 if wall_s > 0 else 0.0
            busy = b / (dur / 1e9) / 1e9 if dur > 0 else 0.0
            edges[edge] = {
                "bytes": b,
                "raw_bytes": raw,
                "count": cnt,
                "dur_ms": round(dur / 1e6, 3),
                "gbps_avg": round(avg, 4),
                "gbps_busy": round(busy, 4),
                "roofline_gbps": roof,
                "roofline_utilization": round(avg / roof, 6)
                if roof > 0 else 0.0,
                "compression_ratio": round(b / raw, 4) if raw else 1.0,
                "sites": sites,
            }
        total = sum(e["bytes"] for e in edges.values())
        return {"total_bytes": total,
                "wall_s": round(wall_s, 6),
                "edges": edges}


# ---------------------------------------------------------------------------
def ledger() -> Optional[DataMovementLedger]:
    """The calling thread's query's ledger, or None when that query is
    unprofiled / movement accounting is off.  With no profiled query
    anywhere this is the profiler's single module-global read."""
    from spark_rapids_tpu_torch.utils import profile as P
    tr = P.tracer()
    if tr is None:
        return None
    return tr.ledger


def record(edge: str, nbytes: int, site: str = "?",
           raw_bytes: Optional[int] = None, dur_ns: int = 0,
           **event_args) -> None:
    """Module-level convenience: record onto the current query's ledger
    (a no-op without one).  Hot call sites that must COMPUTE `nbytes`
    should guard on `ledger() is not None` first."""
    led = ledger()
    if led is not None:
        led.record(edge, nbytes, site=site, raw_bytes=raw_bytes,
                   dur_ns=dur_ns, **event_args)


def move(edge: str, nbytes: int, from_site: str, to_site: str,
         raw_bytes: Optional[int] = None) -> None:
    """Module-level convenience for `DataMovementLedger.move` on the
    current query's ledger (a no-op without one)."""
    led = ledger()
    if led is not None:
        led.move(edge, nbytes, from_site, to_site, raw_bytes=raw_bytes)


def format_report(report: Optional[dict]) -> str:
    """Human-facing rendering of a movement report (the section
    QueryProfile.explain appends)."""
    if not report:
        return "<no movement recorded>"
    lines = [f"total moved: {report['total_bytes'] / 1e6:.2f} MB "
             f"over {report['wall_s'] * 1e3:.1f} ms"]
    for edge, e in report["edges"].items():
        if not e["count"] and not e["sites"]:
            continue
        util = e["roofline_utilization"]
        lines.append(
            f"  {edge:10s} {e['bytes'] / 1e6:10.2f} MB  "
            f"{e['gbps_avg']:8.3f} GB/s avg  "
            f"(roofline {e['roofline_gbps']:.0f} GB/s, "
            f"{util * 100:.2f}% util"
            + (f", ratio {e['compression_ratio']:.2f}"
               if e["raw_bytes"] != e["bytes"] else "")
            + ")")
        for site, v in sorted(e["sites"].items()):
            lines.append(
                f"      {site:24s} {v['bytes'] / 1e6:10.2f} MB  "
                f"x{v['count']}"
                + (f"  {v['dur_ns'] / 1e6:.1f} ms"
                   if v["dur_ns"] else ""))
    return "\n".join(lines)


def vector_device_bytes(col) -> int:
    """Device footprint of one ColumnVector: data, validity, string
    lengths and the 32-bit shadow (the bytes an upload actually ships).
    Each tensor counts `numel() * element_size()` — its logical bytes,
    not `untyped_storage().nbytes()`, which would also charge the
    unused tail of a storage a tensor is a view of."""
    total = 0
    for t in (col.data, col.validity, col.lengths, col.narrow):
        if t is not None:
            total += t.numel() * t.element_size()
    return total
