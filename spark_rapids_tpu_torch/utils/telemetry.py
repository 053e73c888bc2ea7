"""Engine-wide telemetry: live metrics registry, device-utilization
timeline, and Prometheus export (port of
spark_rapids_tpu/utils/telemetry.py).

Each *query* has its own eyes (span trees, event logs, the data-movement
ledger); this module answers the operator's questions while many
sessions run at once: how full device memory is, who holds the
semaphore, how deep the admission queue is, and why the card idles.
It is built on the existing tracer/ledger/heartbeat plumbing:

* **MetricsRegistry** — process-wide counters, gauges, and bounded
  histograms.  Gauges are PULL-based: subsystems do not push on their
  hot paths; the registry reads their existing probes
  (`DeviceManager.telemetry_gauges`, `TpuSemaphore.waiting_count`,
  `QueryScheduler.queue_depth`, the CUDA kernel builds of
  ops/cuda_build.py, `pipeline_stats`, `inflight_count`, store
  `stats()`, `movement.process_edge_totals`) only at scrape/sample
  time.
* **Utilization sampler** — a low-rate daemon thread
  (`telemetry.samplePeriodMs`) attributing each instant to
  busy-compute or a named idle cause — queue wait, semaphore wait,
  pipeline stall, host sync (blocking readbacks + host orchestration
  between device launches), compile (an nvcc build), shuffle wait,
  truly idle — using the already-instrumented heartbeats and queues.
* **Exporters** — Prometheus text exposition behind an opt-in HTTP
  endpoint (`spark.rapids.sql.telemetry.port`, 127.0.0.1, stdlib
  http.server; port 0 of `start(http_port=0)` picks a free one),
  periodic JSONL snapshots riding the profile event-log sink
  (rotation-bounded, utils/profile.py `rotating_append`), and a
  **slow-query log** aggregating completed QueryProfiles by plan
  fingerprint (count, p50/p95 wall, top idle cause).

The port has no kernel cache (it runs eagerly); its `kernel_cache_*`
gauges read the hand-written CUDA kernels' builds instead (libraries
loaded, nvcc builds and their milliseconds; nothing is evicted).

Discipline (the profiler's): with telemetry DISABLED (default) every
hook is one module-global read (`_LIVE is None`) and allocates nothing;
query results are bit-exact either way — telemetry observes, never
perturbs.
"""
from __future__ import annotations

import collections
import hashlib
import json
import logging
import re
import threading
import time
from typing import Callable, Optional

from spark_rapids_tpu_torch import config as C

log = logging.getLogger("spark_rapids_tpu_torch.telemetry")

#: metric name prefix on every exported series
PREFIX = "tpu_rapids_"

#: utilization causes, priority order is in `_classify` — exactly one
#: cause per sample, so percentages sum to 100 by construction
CAUSE_BUSY = "busy"
CAUSE_COMPILE = "compile"
CAUSE_QUEUE = "queue_wait"
CAUSE_SEMAPHORE = "semaphore_wait"
CAUSE_PIPELINE = "pipeline_stall"
CAUSE_SHUFFLE = "shuffle_wait"
CAUSE_HOST = "host_sync"
CAUSE_IDLE = "idle"
CAUSES = (CAUSE_BUSY, CAUSE_COMPILE, CAUSE_QUEUE, CAUSE_SEMAPHORE,
          CAUSE_PIPELINE, CAUSE_SHUFFLE, CAUSE_HOST, CAUSE_IDLE)

#: query wall-clock histogram buckets (seconds)
WALL_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0)

#: bound on wall samples per slow-query-log entry (quantiles stay
#: representative of recent behavior without unbounded growth)
_SLOW_LOG_WALLS = 512


# ---------------------------------------------------------------------------
# metric primitives
class Counter:
    """Monotonic counter, optionally labelled (one label key; children
    keyed by its value)."""

    kind = "counter"

    def __init__(self, name: str, help_: str, label: str = ""):
        self.name = name
        self.help = help_
        self.label = label
        self._lock = threading.Lock()
        self._values: dict[str, float] = {}

    def inc(self, n: float = 1.0, label_value: str = "") -> None:
        with self._lock:
            self._values[label_value] = \
                self._values.get(label_value, 0.0) + n

    def samples(self) -> list[tuple[str, float]]:
        with self._lock:
            return sorted(self._values.items())


class Gauge:
    """Instantaneous value.  Pull-based: `fn` (read at scrape time)
    returns a number, or — with a `label` key — a {label_value: number}
    dict.  `set()` supports the rare push-style gauge."""

    kind = "gauge"

    def __init__(self, name: str, help_: str,
                 fn: Optional[Callable] = None, label: str = ""):
        self.name = name
        self.help = help_
        self.fn = fn
        self.label = label
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def samples(self) -> list[tuple[str, float]]:
        if self.fn is None:
            return [("", self._value)]
        try:
            v = self.fn()
        except Exception:  # noqa: BLE001 — one broken probe must not
            return []      # take down the whole scrape
        if isinstance(v, dict):
            return sorted((str(k), float(x)) for k, x in v.items())
        return [("", float(v))]


class Histogram:
    """Bounded histogram with fixed bucket upper bounds (cumulative at
    render time, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets: tuple):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"buckets": list(self._counts), "sum": self._sum,
                    "count": self._count}


class MetricsRegistry:
    """Name -> metric.  Registration is idempotent by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()

    def _add(self, m):
        with self._lock:
            existing = self._metrics.get(m.name)
            if existing is not None:
                return existing
            self._metrics[m.name] = m
            return m

    def counter(self, name: str, help_: str, label: str = "") -> Counter:
        return self._add(Counter(name, help_, label))

    def gauge(self, name: str, help_: str, fn: Optional[Callable] = None,
              label: str = "") -> Gauge:
        return self._add(Gauge(name, help_, fn, label))

    def histogram(self, name: str, help_: str,
                  buckets: tuple) -> Histogram:
        return self._add(Histogram(name, help_, buckets))

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat {name or name{label}: value} dict (JSONL snapshots,
        watchdog dumps, tests)."""
        out: dict = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                s = m.snapshot()
                out[f"{m.name}_count"] = s["count"]
                out[f"{m.name}_sum"] = round(s["sum"], 6)
                continue
            for lv, v in m.samples():
                key = m.name if not lv else \
                    f"{m.name}{{{m.label}={lv}}}"
                out[key] = v
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                s = m.snapshot()
                cum = 0
                for b, c in zip(m.buckets, s["buckets"]):
                    cum += c
                    lines.append(
                        f'{m.name}_bucket{{le="{_fmt_float(b)}"}} {cum}')
                cum += s["buckets"][-1]
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{m.name}_sum {_fmt_float(s['sum'])}")
                lines.append(f"{m.name}_count {s['count']}")
                continue
            for lv, v in m.samples():
                if lv:
                    lines.append(
                        f'{m.name}{{{m.label}="{_escape_label(lv)}"}} '
                        f"{_fmt_float(v)}")
                else:
                    lines.append(f"{m.name} {_fmt_float(v)}")
        return "\n".join(lines) + "\n"


def _fmt_float(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# ---------------------------------------------------------------------------
# live-query accounting: maintained unconditionally (two lock ops per
# top-level query — nowhere near a hot loop) so a sampler started
# mid-storm still sees the right in-flight count
_ACTIVE_LOCK = threading.Lock()
_ACTIVE_QUERIES = 0


def note_query_begin() -> None:
    global _ACTIVE_QUERIES
    with _ACTIVE_LOCK:
        _ACTIVE_QUERIES += 1


def note_query_end() -> None:
    global _ACTIVE_QUERIES
    with _ACTIVE_LOCK:
        _ACTIVE_QUERIES = max(0, _ACTIVE_QUERIES - 1)


def active_queries() -> int:
    with _ACTIVE_LOCK:
        return _ACTIVE_QUERIES


# ---------------------------------------------------------------------------
class Telemetry:
    """One live telemetry instance per process (module singleton via
    `start`/`stop`)."""

    def __init__(self, conf: C.RapidsConf,
                 http_port: Optional[int] = None):
        self.conf = conf
        self.registry = MetricsRegistry()
        self.started = time.time()
        self._sample_period = max(
            0.005, float(conf[C.TELEMETRY_SAMPLE_PERIOD_MS]) / 1e3)
        self._timeline: "collections.deque[tuple]" = collections.deque(
            maxlen=max(16, int(conf[C.TELEMETRY_TIMELINE_SIZE])))
        self._cause_counts = {c: 0 for c in CAUSES}
        self._tl_lock = threading.Lock()
        self._stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None
        self._http = None
        self._http_thread: Optional[threading.Thread] = None
        self.http_port: Optional[int] = None
        self._requested_port = http_port
        # slow-query log: plan fingerprint -> aggregate
        self._slow_lock = threading.Lock()
        self._slow: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._slow_bound = max(1, int(conf[C.TELEMETRY_SLOW_QUERY_LOG_SIZE]))
        self._wall_hist: Optional[Histogram] = None
        self._completed: Optional[Counter] = None
        self._util_counter: Optional[Counter] = None
        self._kernel_counter: Optional[Counter] = None
        self._snap_period = float(conf[C.TELEMETRY_SNAPSHOT_PERIOD_S])
        self._next_snap = time.monotonic() + self._snap_period

    # -- lifecycle ------------------------------------------------------------
    def _start(self) -> None:
        self._register_default_metrics()
        port = self._requested_port
        if port is None:
            port = int(self.conf[C.TELEMETRY_PORT])
            if port <= 0:
                port = None  # conf 0 = no server
        if port is not None:
            self._start_http(max(0, port))  # 0 = ephemeral (tests)
        self._sampler = threading.Thread(target=self._sample_loop,
                                         daemon=True,
                                         name="tpu-telemetry")
        self._sampler.start()

    def _shutdown(self) -> None:
        self._stop.set()
        if self._http is not None:
            try:
                self._http.shutdown()
                self._http.server_close()
            except Exception:  # noqa: BLE001
                pass
            self._http = None
        t = self._sampler
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2.0)

    # -- HTTP endpoint --------------------------------------------------------
    def _start_http(self, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        telem = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path in ("/", "/metrics"):
                    body = telem.registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/telemetry":
                    body = json.dumps(telem.snapshot()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not log spam
                pass

        self._http = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._http.daemon_threads = True
        self.http_port = self._http.server_address[1]
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name="tpu-telemetry-http")
        self._http_thread.start()

    # -- utilization sampler --------------------------------------------------
    def _sample_loop(self) -> None:
        while not self._stop.wait(self._sample_period):
            try:
                cause = self._classify()
            except Exception:  # noqa: BLE001 — a probe race must not
                continue       # kill the sampler
            now = time.time()
            with self._tl_lock:
                self._timeline.append((now, cause))
                self._cause_counts[cause] += 1
            if self._util_counter is not None:
                self._util_counter.inc(1, cause)
            self._maybe_snapshot_jsonl()

    def _classify(self) -> str:
        """Attribute this instant to exactly one cause.  Priority
        order: an nvcc build blocks its query even while holding the
        semaphore, so it outranks busy; a held semaphore means device
        work is in flight (busy-compute in this host-driven engine);
        the wait causes follow in front-door-to-backend order; a query
        in flight with none of the wait signals live is host
        orchestration / blocking readback time (host_sync); no query
        in flight is truly idle."""
        from spark_rapids_tpu_torch.utils import watchdog as W
        for hb in W.active_heartbeats():
            if hb.kind == "compile" and not getattr(hb, "_paused", 0):
                return CAUSE_COMPILE
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        sem = TpuSemaphore._instance
        if sem is not None and sem.holders() > 0:
            return CAUSE_BUSY
        from spark_rapids_tpu_torch.exec.scheduler import QueryScheduler
        sched = QueryScheduler._instance
        if sched is not None and sched.queue_depth() > 0:
            return CAUSE_QUEUE
        if sem is not None and sem.waiting_count() > 0:
            return CAUSE_SEMAPHORE
        from spark_rapids_tpu_torch.exec.pipeline import pipeline_live
        live = pipeline_live()
        if live["stalled_consumers"] > 0 or live["blocked_producers"] > 0:
            return CAUSE_PIPELINE
        from spark_rapids_tpu_torch.shuffle.client_server import inflight_count
        if inflight_count() > 0:
            return CAUSE_SHUFFLE
        if active_queries() > 0:
            return CAUSE_HOST
        return CAUSE_IDLE

    def _maybe_snapshot_jsonl(self) -> None:
        if self._snap_period <= 0:
            return
        now = time.monotonic()
        if now < self._next_snap:
            return
        self._next_snap = now + self._snap_period
        path = str(self.conf[C.PROFILE_EVENT_LOG_PATH])
        if not path:
            return
        path = path.replace("{query_id}", "telemetry")
        try:
            from spark_rapids_tpu_torch.utils import profile as P
            rec = {"kind": P.EV_TELEMETRY_SNAPSHOT, "ts": time.time(),
                   **self.snapshot()}
            P.rotating_append(
                path, json.dumps(rec) + "\n",
                int(self.conf[C.PROFILE_EVENT_LOG_MAX_BYTES]),
                int(self.conf[C.PROFILE_EVENT_LOG_KEEP_FILES]))
        except OSError:
            log.warning("could not append telemetry snapshot",
                        exc_info=True)

    # -- utilization views ----------------------------------------------------
    def utilization_timeline(self) -> list[tuple]:
        """Recent (unix_ts, cause) samples, oldest first (bounded by
        telemetry.timelineSize)."""
        with self._tl_lock:
            return list(self._timeline)

    def utilization_counts(self) -> dict:
        with self._tl_lock:
            return dict(self._cause_counts)

    def utilization_summary(self,
                            baseline: Optional[dict] = None) -> dict:
        """Percentage per cause (sums to ~100 when any samples exist)
        plus the sample count.  With `baseline` (a prior
        `utilization_counts` snapshot) the summary covers only samples
        since — the per-bench breakdown."""
        counts = self.utilization_counts()
        if baseline:
            # clamp at 0: a baseline taken from a PREVIOUS telemetry
            # instance (stop/restart between marks) must not go negative
            counts = {c: max(0, counts.get(c, 0) - baseline.get(c, 0))
                      for c in counts}
        total = sum(counts.values())
        out = {"samples": total}
        for c in CAUSES:
            n = counts.get(c, 0)
            if total > 0 and n:
                out[c] = round(100.0 * n / total, 1)
        return out

    # -- kernel attribution (utils/kernelprof.py) -----------------------------
    def note_kernel_sample(self, family: str, seconds: float) -> None:
        """One sampled kernel dispatch: bump the per-family device-time
        counter and the family's bounded duration histogram (created
        lazily on the first sample of each family)."""
        if self._kernel_counter is not None:
            self._kernel_counter.inc(seconds, family)
        from spark_rapids_tpu_torch.utils.kernelprof import TIME_BUCKETS
        name = (PREFIX + "kernel_time_seconds_"
                + _sanitize_metric(family))
        self.registry.histogram(
            name, f"Sampled device-time distribution of the "
            f"'{family}' kernel family.", TIME_BUCKETS).observe(seconds)

    # -- slow-query log -------------------------------------------------------
    def note_profile(self, profile, plan) -> None:
        """Aggregate one completed QueryProfile into the slow-query log
        (keyed by plan fingerprint) and the wall-clock histogram."""
        if self._wall_hist is not None:
            self._wall_hist.observe(profile.wall_s)
        if self._completed is not None:
            self._completed.inc(1)
        fp, desc = _plan_fingerprint(plan)
        b = profile.breakdown or {}
        with self._slow_lock:
            entry = self._slow.get(fp)
            if entry is None:
                entry = self._slow[fp] = {
                    "plan": desc,
                    "count": 0,
                    "walls": collections.deque(maxlen=_SLOW_LOG_WALLS),
                    "idle_s": {},
                    "wall_sum_s": 0.0,
                    "kernel_s": {},
                    "hwm": collections.deque(maxlen=_SLOW_LOG_WALLS),
                }
            entry["count"] += 1
            entry["walls"].append(profile.wall_s)
            # observed HBM high-water per plan shape (utils/residency
            # .py) — the feed ROADMAP item 5's learned admission
            # budgets consume in place of the static queryBudgetBytes
            res = getattr(profile, "residency", None) or {}
            hw = res.get("hbm_high_water")
            if hw:
                entry.setdefault(
                    "hwm",
                    collections.deque(maxlen=_SLOW_LOG_WALLS)
                ).append(int(hw))
            entry["wall_sum_s"] += profile.wall_s
            for k, v in b.items():
                if k in ("wall_s", "compute_s") or not v:
                    continue
                entry["idle_s"][k] = entry["idle_s"].get(k, 0.0) + v
            # per-kernel attribution: accumulate each kernel's device
            # seconds so repeat offenders name their hot kernel next
            # to their top idle cause
            for row in getattr(profile, "kernels", None) or []:
                if not row.get("device_ms"):
                    continue
                key = (row["fingerprint"], row["label"])
                ks = entry["kernel_s"]
                ks[key] = ks.get(key, 0.0) + row["device_ms"] / 1e3
            self._slow.move_to_end(fp)
            while len(self._slow) > self._slow_bound:
                self._slow.popitem(last=False)

    def slow_query_log(self) -> list[dict]:
        """Aggregated per-fingerprint entries, slowest (p95) first."""
        with self._slow_lock:
            items = [(fp,
                      {**e, "kernel_s": dict(e.get("kernel_s") or {}),
                       "hwm": list(e.get("hwm") or [])},
                      list(e["walls"]))
                     for fp, e in self._slow.items()]
        out = []
        for fp, e, walls in items:
            walls.sort()
            idle = e["idle_s"]
            top = max(idle.items(), key=lambda kv: kv[1]) \
                if idle else ("compute_s", 0.0)
            wall_sum = e["wall_sum_s"]
            rec = {
                "fingerprint": fp,
                "plan": e["plan"],
                "count": e["count"],
                "p50_ms": round(_quantile(walls, 0.5) * 1e3, 2),
                "p95_ms": round(_quantile(walls, 0.95) * 1e3, 2),
                "max_ms": round(walls[-1] * 1e3, 2) if walls else 0.0,
                "top_idle_cause": top[0],
                "top_idle_pct": round(100.0 * top[1] / wall_sum, 1)
                if wall_sum > 0 else 0.0,
            }
            # observed HBM high-water marks of this plan shape: the
            # admission-budget sizing feed (p95 + headroom is the
            # recipe the tuning guide documents)
            hwm = sorted(e.get("hwm") or [])
            if hwm:
                rec["hbm_high_water"] = {
                    "p50_bytes": int(_quantile(hwm, 0.5)),
                    "p95_bytes": int(_quantile(hwm, 0.95)),
                    "max_bytes": int(hwm[-1]),
                }
            # hottest kernel of this plan shape (kernelprof rows ride
            # the aggregated profiles): fingerprint + its share of the
            # shape's total attributed device time
            kernel_s = e.get("kernel_s") or {}
            if kernel_s:
                (kfp, klabel), ksec = max(kernel_s.items(),
                                          key=lambda kv: kv[1])
                ktotal = sum(kernel_s.values())
                rec["top_kernel"] = {
                    "fingerprint": kfp,
                    "label": klabel,
                    "device_share_pct": round(100.0 * ksec / ktotal, 1)
                    if ktotal > 0 else 0.0,
                }
            out.append(rec)
        out.sort(key=lambda e: e["p95_ms"], reverse=True)
        return out

    # -- combined views -------------------------------------------------------
    def snapshot(self) -> dict:
        return {"gauges": self.registry.snapshot(),
                "utilization": self.utilization_summary(),
                "active_queries": active_queries(),
                "slow_queries": self.slow_query_log()[:8],
                "residency": _residency_view()}

    def describe_for_dump(self, samples: int = 8) -> str:
        """Multi-line rendering for the watchdog dump: every gauge plus
        the last few utilization samples."""
        lines = [f"  utilization: {self.utilization_summary()}"]
        tl = self.utilization_timeline()[-samples:]
        if tl:
            lines.append("  recent samples: "
                         + " ".join(f"{c}" for _, c in tl))
        for k, v in sorted(self.registry.snapshot().items()):
            lines.append(f"  {k} = {_fmt_float(v)}")
        return "\n".join(lines)

    # -- default metric wiring ------------------------------------------------
    def _register_default_metrics(self) -> None:
        r = self.registry
        # HBM / device manager + admission ledger
        r.gauge(PREFIX + "hbm_total_bytes",
                "Total device memory (the card's, or the configured budget's "
                "base).",
                fn=_dm_gauge("hbm_total"))
        r.gauge(PREFIX + "hbm_budget_bytes",
                "Accounted arena budget (total*allocFraction - reserve).",
                fn=_dm_gauge("budget"))
        r.gauge(PREFIX + "hbm_store_bytes",
                "Bytes resident in the device store.",
                fn=_dm_gauge("store_bytes"))
        r.gauge(PREFIX + "hbm_reserved_bytes",
                "Outstanding operator reservations.",
                fn=_dm_gauge("reserved_bytes"))
        r.gauge(PREFIX + "hbm_admitted_bytes",
                "Sum of admitted query budgets (admission ledger).",
                fn=_dm_gauge("admitted_bytes"))
        r.gauge(PREFIX + "hbm_admitted_queries",
                "Queries holding an admission-ledger slot.",
                fn=_dm_gauge("admitted_queries"))
        r.gauge(PREFIX + "hbm_in_use_bytes",
                "Store-resident + reserved bytes (the accounted "
                "arena's live total — the reserved-vs-store split's "
                "sum).",
                fn=_dm_gauge("in_use_bytes"))
        r.gauge(PREFIX + "hbm_admission_headroom_bytes",
                "budget - store - reserved - sum(admitted budgets): "
                "the admission room try_admit actually has left "
                "(negative = running queries outgrew their declared "
                "budgets).",
                fn=_dm_gauge("admission_headroom_bytes"))
        r.gauge(PREFIX + "store_bytes_underflow_total",
                "Store-byte accounting updates clamped at zero "
                "(double-free indicator) since start.",
                fn=_dm_gauge("store_bytes_underflow"))
        # HBM residency ledger (utils/residency.py): populated while
        # residency tracking is on (sticky from the first
        # residency-enabled profiled query)
        r.gauge(PREFIX + "hbm_resident_bytes",
                "Tracked resident bytes per storage tier "
                "(provenance-registered buffers, reservations, gang "
                "pins).",
                fn=_residency_tiers, label="tier")
        r.gauge(PREFIX + "hbm_resident_site_bytes",
                "Tracked device-resident bytes per provenance site.",
                fn=_residency_device_sites, label="site")
        r.gauge(PREFIX + "residency_leaks_total",
                "Tracked buffers flagged still-resident at their "
                "owning query's end since start.",
                fn=_residency_leaks)
        r.gauge(PREFIX + "spill_bytes_total",
                "Bytes spilled by the pressure callback since start.",
                fn=_spill_gauge("bytes_spilled"))
        r.gauge(PREFIX + "spill_count_total",
                "Pressure-callback spill passes since start.",
                fn=_spill_gauge("spill_count"))
        r.gauge(PREFIX + "store_bytes",
                "Bytes resident per spill tier.",
                fn=_store_sizes, label="tier")
        r.gauge(PREFIX + "store_buffers",
                "Buffer count per spill tier.",
                fn=_store_counts, label="tier")
        # device semaphore
        r.gauge(PREFIX + "semaphore_max_concurrent",
                "Permit count (spark.rapids.sql.concurrentGpuTasks).",
                fn=_sem_gauge(lambda s: s.max_concurrent))
        r.gauge(PREFIX + "semaphore_available_permits",
                "Free permits right now.",
                fn=_sem_gauge(lambda s: s.available_permits()))
        r.gauge(PREFIX + "semaphore_holders",
                "Tasks currently holding the accelerator.",
                fn=_sem_gauge(lambda s: s.holders()))
        r.gauge(PREFIX + "semaphore_waiters",
                "Tasks currently blocked waiting for a permit.",
                fn=_sem_gauge(lambda s: s.waiting_count()))
        r.gauge(PREFIX + "semaphore_longest_wait_ms",
                "Longest blocked acquire observed.",
                fn=_sem_gauge(lambda s: s.wait_stats()["longest_wait_ms"]))
        r.gauge(PREFIX + "semaphore_waits_total",
                "Blocked acquires since start.",
                fn=_sem_gauge(lambda s: s.wait_stats()["wait_count"]))
        # query scheduler
        r.gauge(PREFIX + "scheduler_queue_depth",
                "Queries parked in the admission queue right now.",
                fn=_sched_gauge(lambda s: s.queue_depth()))
        r.gauge(PREFIX + "scheduler_admitted_total",
                "Queries admitted since start.",
                fn=_sched_stat("admitted"))
        r.gauge(PREFIX + "scheduler_queued_total",
                "Queries that had to queue before admission.",
                fn=_sched_stat("queued"))
        r.gauge(PREFIX + "scheduler_rejected_total",
                "Queries shed (queue full or queue timeout).",
                fn=_sched_stat("rejected"))
        r.gauge(PREFIX + "scheduler_queue_timeouts_total",
                "Queries shed specifically by queueTimeout.",
                fn=_sched_stat("queue_timeouts"))
        r.gauge(PREFIX + "active_queries",
                "Top-level queries in flight (including unmanaged).",
                fn=active_queries)
        # hand-written CUDA kernels (the port runs eagerly: no cache
        # of compiled executables)
        r.gauge(PREFIX + "kernel_cache_entries",
                "Hand-written CUDA kernel libraries loaded.",
                fn=_build_fn("loaded_count"))
        r.gauge(PREFIX + "kernel_cache_evictions_total",
                "Kernel libraries unloaded since start (always 0).",
                fn=lambda: 0)
        r.gauge(PREFIX + "kernel_cache_compiles_total",
                "nvcc builds since start.",
                fn=_build_fn("build_count"))
        r.gauge(PREFIX + "kernel_cache_compile_ms_total",
                "Wall milliseconds spent in nvcc builds.",
                fn=_build_fn("build_ms"))
        # prefetch pipeline
        r.gauge(PREFIX + "prefetch_hits_total",
                "Consumer pulls served from an already-full queue.",
                fn=_pipeline_stat("hits"))
        r.gauge(PREFIX + "prefetch_stalls_total",
                "Consumer pulls that blocked on the producer.",
                fn=_pipeline_stat("stalls"))
        r.gauge(PREFIX + "prefetch_wait_ms_total",
                "Milliseconds consumers spent blocked on empty queues.",
                fn=_pipeline_stat("wait_ns", scale=1e-6))
        r.gauge(PREFIX + "prefetch_producers_total",
                "Producer threads started since start.",
                fn=_pipeline_stat("producers"))
        r.gauge(PREFIX + "prefetch_leaked_producers_total",
                "Producers that survived close() joins (wedged).",
                fn=_pipeline_stat("leaked_producers"))
        r.gauge(PREFIX + "pipeline_stalled_consumers",
                "Consumers blocked on an empty prefetch queue NOW.",
                fn=_pipeline_live_stat("stalled_consumers"))
        r.gauge(PREFIX + "pipeline_blocked_producers",
                "Producers parked on a full prefetch queue NOW.",
                fn=_pipeline_live_stat("blocked_producers"))
        # shuffle / recovery / speculation
        r.gauge(PREFIX + "shuffle_inflight_fetches",
                "Block fetches outstanding right now.",
                fn=_inflight_count)
        r.gauge(PREFIX + "shuffle_executors",
                "Live in-process shuffle executors.",
                fn=_shuffle_executors)
        r.gauge(PREFIX + "speculation_launched_total",
                "Speculative duplicate attempts launched.",
                fn=_spec_stat("launched"))
        r.gauge(PREFIX + "speculation_wins_total",
                "Speculative attempts that beat the original.",
                fn=_spec_stat("wins"))
        r.gauge(PREFIX + "watchdog_timeouts_total",
                "Watchdog deadline expirations declared.",
                fn=_watchdog_stat("timeouts"))
        r.gauge(PREFIX + "watchdog_cancels_total",
                "CancelTokens fired by the watchdog.",
                fn=_watchdog_stat("cancels"))
        # kernel attribution (utils/kernelprof.py)
        r.gauge(PREFIX + "kernel_catalog_entries",
                "Kernels in the process-wide attribution catalog.",
                fn=_kernelprof_catalog_size)
        r.gauge(PREFIX + "kernel_family_device_seconds",
                "Cumulative SAMPLED device seconds per kernel family "
                "(pull-side mirror of kernel_device_seconds_total).",
                fn=_kernelprof_family_seconds, label="family")
        self._kernel_counter = r.counter(
            PREFIX + "kernel_device_seconds_total",
            "Device seconds measured by sampled kernel dispatches, "
            "per kernel family (requires "
            "spark.rapids.sql.profile.kernels.enabled).",
            label="family")
        # host syncs + movement
        r.gauge(PREFIX + "host_syncs_total",
                "Blocking device->host readbacks observed.",
                fn=_host_syncs)
        r.gauge(PREFIX + "movement_bytes_total",
                "Cumulative data-movement ledger bytes per edge "
                "(populated while profiled queries run with "
                "movement accounting on).",
                fn=_movement_totals, label="edge")
        # result cache
        r.gauge(PREFIX + "result_cache_entries",
                "Entries in the plan-fingerprint result cache.",
                fn=_result_cache_stat("entries"))
        r.gauge(PREFIX + "result_cache_bytes",
                "Bytes held by the result cache.",
                fn=_result_cache_stat("bytes"))
        r.gauge(PREFIX + "result_cache_hits_total",
                "Result-cache hits since start.",
                fn=_result_cache_stat("hits"))
        # per-query aggregates (pushed by note_profile)
        self._completed = r.counter(
            PREFIX + "queries_completed_total",
            "Profiled queries completed since telemetry start.")
        self._wall_hist = r.histogram(
            PREFIX + "query_wall_seconds",
            "Wall-clock distribution of completed profiled queries.",
            WALL_BUCKETS)
        self._util_counter = r.counter(
            PREFIX + "utilization_samples_total",
            "Utilization-sampler ticks per attributed cause.",
            label="cause")


# ---------------------------------------------------------------------------
# defensive gauge probes: every closure tolerates the subsystem not
# being initialized (returns 0) and NEVER constructs a singleton — a
# scrape must not boot the device
def _dm_gauge(attr: str):
    def fn():
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        dm = DeviceManager.peek()
        if dm is None:
            return 0
        return dm.telemetry_gauges().get(attr, 0)
    return fn


def _spill_gauge(attr: str):
    def fn():
        from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
        dm = DeviceManager.peek()
        cb = dm.spill_callback if dm is not None else None
        return getattr(cb, attr, 0) if cb is not None else 0
    return fn


def _store_stats() -> dict:
    from spark_rapids_tpu_torch.memory.env import ResourceEnv
    env = ResourceEnv.peek()
    if env is None:
        return {}
    return {"device": env.device_store.stats(),
            "host": env.host_store.stats(),
            "disk": env.disk_store.stats()}


def _store_sizes() -> dict:
    return {t: s["bytes"] for t, s in _store_stats().items()}


def _store_counts() -> dict:
    return {t: s["buffers"] for t, s in _store_stats().items()}


def _sem_gauge(fn_):
    def fn():
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        sem = TpuSemaphore._instance
        return fn_(sem) if sem is not None else 0
    return fn


def _sched_gauge(fn_):
    def fn():
        from spark_rapids_tpu_torch.exec.scheduler import QueryScheduler
        s = QueryScheduler._instance
        return fn_(s) if s is not None else 0
    return fn


def _sched_stat(key: str):
    return _sched_gauge(lambda s: s.stats().get(key, 0))


def _build_fn(name: str):
    def fn():
        from spark_rapids_tpu_torch.ops import cuda_build as CB
        return getattr(CB, name)()
    return fn


def _pipeline_stat(key: str, scale: float = 1.0):
    def fn():
        from spark_rapids_tpu_torch.exec.pipeline import pipeline_stats
        return pipeline_stats().get(key, 0) * scale
    return fn


def _pipeline_live_stat(key: str):
    def fn():
        from spark_rapids_tpu_torch.exec.pipeline import pipeline_live
        return pipeline_live().get(key, 0)
    return fn


def _inflight_count():
    from spark_rapids_tpu_torch.shuffle.client_server import inflight_count
    return inflight_count()


def _shuffle_executors():
    from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager
    return TpuShuffleManager.live_executors()


def _spec_stat(key: str):
    def fn():
        from spark_rapids_tpu_torch.exec.speculation import speculation_stats
        return speculation_stats().get(key, 0)
    return fn


def _watchdog_stat(key: str):
    def fn():
        from spark_rapids_tpu_torch.utils.watchdog import watchdog_stats
        return watchdog_stats().get(key, 0)
    return fn


def _host_syncs():
    from spark_rapids_tpu_torch.utils import checks as CK
    return CK.host_sync_count()


def _movement_totals():
    from spark_rapids_tpu_torch.utils.movement import process_edge_totals
    return process_edge_totals()


def _residency_tiers():
    from spark_rapids_tpu_torch.utils import residency as RS
    return RS.by_tier() if RS.enabled() else {}


def _residency_device_sites():
    from spark_rapids_tpu_torch.utils import residency as RS
    return RS.by_site(RS.TIER_DEVICE) if RS.enabled() else {}


def _residency_leaks():
    from spark_rapids_tpu_torch.utils import residency as RS
    return RS.leaks_total()


def _residency_view() -> dict:
    """The /telemetry JSON residency section: tracking state, per-tier
    totals, and the top holders (who owns the memory, right now)."""
    from spark_rapids_tpu_torch.utils import residency as RS
    if not RS.enabled():
        return {"enabled": False}
    return {"enabled": True,
            "tiers": RS.by_tier(),
            "leaks_total": RS.leaks_total(),
            "holders": RS.holders(limit=8)}


def _kernelprof_catalog_size():
    from spark_rapids_tpu_torch.utils.kernelprof import catalog_size
    return catalog_size()


def _kernelprof_family_seconds():
    from spark_rapids_tpu_torch.utils.kernelprof import family_device_seconds
    return family_device_seconds()


def _sanitize_metric(s: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", s).strip("_").lower()


def _result_cache_stat(key: str):
    def fn():
        from spark_rapids_tpu_torch.exec.scheduler import result_cache
        return result_cache().stats().get(key, 0)
    return fn


# ---------------------------------------------------------------------------
def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _plan_fingerprint(plan) -> tuple[str, str]:
    """(stable fingerprint, short description) of a plan's SHAPE:
    hashes the describe() tree, which is stable across plan instances
    of the same query text but free of runtime metrics."""
    if plan is None:
        return "no-plan", "<no plan>"
    parts: list[str] = []

    def walk(node, depth):
        try:
            desc = node.describe() if hasattr(node, "describe") \
                else type(node).__name__
        except Exception:  # noqa: BLE001 — fingerprint must not fail
            desc = type(node).__name__
        parts.append(f"{depth}:{desc}")
        for c in getattr(node, "children", []) or []:
            walk(c, depth + 1)
        for attr in ("exchange", "stage"):
            inner = getattr(node, attr, None)
            if inner is not None and inner not in (
                    getattr(node, "children", []) or []):
                walk(inner, depth + 1)

    try:
        walk(plan, 0)
    except Exception:  # noqa: BLE001
        pass
    blob = "\n".join(parts)
    fp = hashlib.md5(blob.encode()).hexdigest()[:12]
    return fp, (parts[0].split(":", 1)[1][:120] if parts else "<plan>")


# ---------------------------------------------------------------------------
# module singleton + allocation-free hooks
_START_LOCK = threading.Lock()
_LIVE: Optional[Telemetry] = None


def live() -> Optional[Telemetry]:
    """The running Telemetry instance, or None (the disabled-path gate:
    one module-global read)."""
    return _LIVE


def start(conf: Optional[C.RapidsConf] = None,
          http_port: Optional[int] = None) -> Telemetry:
    """Start process-wide telemetry (idempotent).  `http_port`
    overrides the conf port: 0 binds an ephemeral port (tests), None
    defers to `spark.rapids.sql.telemetry.port` (whose 0 means no
    server)."""
    global _LIVE
    with _START_LOCK:
        if _LIVE is not None:
            return _LIVE
        t = Telemetry(conf if conf is not None else C.get_active_conf(),
                      http_port=http_port)
        t._start()
        _LIVE = t
        return t


def stop() -> None:
    """Stop and discard the running instance (tests / shutdown)."""
    global _LIVE
    with _START_LOCK:
        t, _LIVE = _LIVE, None
    if t is not None:
        t._shutdown()


def maybe_start(conf: C.RapidsConf) -> Optional[Telemetry]:
    """Start telemetry iff the conf enables it.  The disabled path is
    one global read + one conf lookup, no allocation."""
    if _LIVE is not None:
        return _LIVE
    if not conf[C.TELEMETRY_ENABLED]:
        return None
    return start(conf)


def note_kernel_sample(family: str, seconds: float) -> None:
    """Hook for kernelprof's sampled timing lane (no-op when telemetry
    is off — one module-global read)."""
    t = _LIVE
    if t is None:
        return
    try:
        t.note_kernel_sample(family, seconds)
    except Exception:  # noqa: BLE001 — telemetry must never fail a query
        log.warning("kernel-sample aggregation failed", exc_info=True)


def note_query_profile(profile, plan) -> None:
    """Hook for profile.end_query: aggregate a completed QueryProfile
    into the slow-query log (no-op when telemetry is off)."""
    t = _LIVE
    if t is None:
        return
    try:
        t.note_profile(profile, plan)
    except Exception:  # noqa: BLE001 — telemetry must never fail a query
        log.warning("slow-query-log aggregation failed", exc_info=True)


def prometheus_text() -> str:
    t = _LIVE
    return t.registry.prometheus_text() if t is not None else ""


def snapshot() -> Optional[dict]:
    t = _LIVE
    return t.snapshot() if t is not None else None


def describe_for_dump() -> str:
    t = _LIVE
    if t is None:
        return "  <telemetry disabled>"
    try:
        return t.describe_for_dump()
    except Exception as e:  # noqa: BLE001 — diagnostics only
        return f"  <telemetry unavailable: {e}>"
