"""Per-kernel performance attribution: device timing, analytic cost, and
the roofline join (port of spark_rapids_tpu/utils/kernelprof.py).

The profiler (utils/profile.py) times spans, the ledger
(utils/movement.py) prices host<->device edges, and the sampler
(utils/telemetry.py) names idle causes; none of them can say WHICH
kernel inside a slow lane burns the time, or what fraction of the
card's FLOP/byte roofline it reaches.  This module is that layer.

The design differs from the reference's, whose catalog rides its kernel
cache: every XLA executable passes through `KernelCache.get_or_build`
(reference exec/base.py), its every Nth dispatch is wall-timed behind
`jax.block_until_ready`, and its FLOPs and bytes come from XLA's
`cost_analysis()`.  The port runs eagerly and has no kernel cache
(exec/base.py), no executable to wrap and no compiler to ask for a
cost.  So:

* **Catalog keyed at the reference's cache sites** — each eager device
  step at the port's counterpart of one of the reference's
  `get_or_build` call sites runs inside a `watch(identity)` context
  (through `TpuExec.kp_step` in the execs, directly in the shuffle
  partitioner), keyed by (exec class and description, the reference's
  kernel label and the input's capacity).  Each hand-written CUDA
  kernel has entries of its own, opened by its wrapper around each
  launch (ops/kernels.py, ops/grouped_window.py), so a catalog entry's
  launch count equals the wrapper's `.launches` delta.
* **Sampled timing with CUDA events** — every Nth entry of each kernel
  (`spark.rapids.sql.profile.kernels.sampleRate`) records a pair of
  CUDA events on the current stream around the step, in place of the
  reference's `block_until_ready` bracket.  Nothing waits on them then:
  a profiled query resolves its events' elapsed times at `end_query`
  (one wait on its last event, accounted through
  `utils.checks.note_host_sync` as ``kernelprof.resolve``), and the
  process catalog resolves the rest when read.  So sampling adds no
  host sync per launch.  A step on the CPU runs synchronously; its
  sampled time is the host clock's.  What a pair measures depends on
  the entry.  A hand kernel's start event is queued behind a short spin
  (`QUEUE_SPIN_CYCLES`, ~1 ms of the card's clock), so the host
  enqueues the launch while the stream is still busy and the pair holds
  the kernel alone: its sampled time is device time, the figure its
  roofline share divides by.  Without the spin the pair also held the
  launch's host time (the ctypes call, ~10-60 us) whenever the stream
  was idle, which is most of the time in a host-bound engine.  An exec
  site's pair brackets the stream from the step's first enqueue to its
  last, host gaps between its eager ops included: a stream time, so the
  roofline share of a site's row is a lower bound.
* **Analytic cost** — bytes of the step's inputs and outputs, taken once
  per entry (`…kernels.costAnalysis`); for the three hand kernels also
  their FLOPs, by the formula `chip_smoke.py`'s `bound()` uses.  The
  roofline join then reads the same work whatever implements a step.
* **Compile time** — the one-time nvcc build (ops/cuda_build.py) is
  charged to the built kernel's entries as build time, and a sample
  whose bracket held a build (`cuda_build.build_count()` moved) is
  charged as compile, never as device time.

Discipline (the profiler's): DISABLED (default) `watch` returns one
shared null context, and `TpuExec.kp_step` builds no identity, so the
hot loop is bit-identical and allocation-free.  Enabling is
process-sticky.
"""
from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Optional

#: sampled-duration histogram bucket upper bounds (seconds)
TIME_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                1e-1, 3e-1, 1.0, 3.0)

#: bound on per-query Perfetto kernel samples
MAX_QUERY_SAMPLES = 1 << 12

#: bound on distinct owner describe-strings per catalog entry (shared
#: kernels accumulate owners across plan instances)
MAX_OWNERS = 8

#: bound on a catalog entry's unresolved CUDA event pairs (resolved on
#: read; a process that never reads keeps the newest)
MAX_PENDING = 1 << 12

#: identity scope of the hand-written CUDA kernels' entries
HAND_SCOPE = "cuda-kernel"

# ---------------------------------------------------------------------------
# module state: ONE global read (`_ENABLED`) gates every hook
_ENABLED = False
_RATE = 8
_COST = True
_LOCK = threading.Lock()
#: structural identity (scope, key) -> KernelEntry
_CATALOG: "collections.OrderedDict" = collections.OrderedDict()
#: clock cycles of the spin queued ahead of a sampled hand-kernel
#: entry's start event (~1 ms at an H100's 1.98 GHz): longer than the
#: host takes from the start event to the launch, even when another
#: thread holds the interpreter lock for a while, so the launch is
#: queued before the stream reaches the start event
QUEUE_SPIN_CYCLES = 2_000_000


def enabled() -> bool:
    """The disabled-path gate: one module-global read."""
    return _ENABLED


def maybe_enable(conf) -> bool:
    """Sticky process-wide enable, driven by the first query whose conf
    sets spark.rapids.sql.profile.kernels.enabled.  A later enabling
    conf refreshes the sample rate (last writer wins)."""
    from spark_rapids_tpu_torch import config as C
    if not conf[C.KERNELPROF_ENABLED]:
        return _ENABLED
    enable(conf)
    return True


def enable(conf=None) -> None:
    global _ENABLED, _RATE, _COST
    from spark_rapids_tpu_torch import config as C
    conf = conf if conf is not None else C.get_active_conf()
    with _LOCK:
        _RATE = max(1, int(conf[C.KERNELPROF_SAMPLE_RATE]))
        _COST = bool(conf[C.KERNELPROF_COST_ANALYSIS])
        _ENABLED = True


def disable() -> None:
    """Stop attributing; the catalog stays readable."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False


def reset() -> None:
    """Tests: drop the catalog and disable attribution."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
        _CATALOG.clear()


# ---------------------------------------------------------------------------
def tensor_bytes(*objs) -> int:
    """Logical bytes of the tensors in `objs`, walking ColumnarBatches,
    ColumnVectors, lists, tuples and dicts (`numel() * element_size()`
    each, as utils/movement.vector_device_bytes counts)."""
    import torch
    total = 0
    stack = list(objs)
    while stack:
        o = stack.pop()
        if o is None:
            continue
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif hasattr(o, "device_size_bytes"):
            total += int(o.device_size_bytes())
        elif hasattr(o, "validity") and hasattr(o, "data"):
            from spark_rapids_tpu_torch.utils.movement import \
                vector_device_bytes
            total += vector_device_bytes(o)
    return total


def note_build(name: str, ns: int) -> None:
    """Charge one nvcc build of `csrc/<name>.cu` to the kernel's entries
    (called by ops/cuda_build.py while attribution is on)."""
    with _LOCK:
        entries = [e for ident, e in _CATALOG.items()
                   if ident[0] == (HAND_SCOPE, name)]
        if not entries:
            e = KernelEntry(((HAND_SCOPE, name), ("build",)))
            _CATALOG[e.identity] = e
            entries = [e]
    entries[0].note_build(ns)


# ---------------------------------------------------------------------------
class KernelEntry:
    """Process-lifetime attribution record for one kernel identity."""

    def __init__(self, identity: tuple):
        self.identity = identity
        blob = repr(identity).encode()
        self.fingerprint = hashlib.md5(blob).hexdigest()[:12]
        scope, key = identity
        scope0 = scope[0] if isinstance(scope, tuple) and scope \
            and isinstance(scope[0], str) else "?"
        key0 = key[0] if isinstance(key, tuple) and key \
            and isinstance(key[0], str) else "kernel"
        #: coarse aggregation key (exec class / kernel kind) for the
        #: telemetry per-family histograms
        self.family = f"{scope0}/{key0}"
        self.label = (scope[1] if scope0 == HAND_SCOPE and len(scope) > 1
                      else self.family)
        self._lock = threading.Lock()
        self.owners: "collections.OrderedDict[int, str]" = \
            collections.OrderedDict()
        self.members: Optional[list] = None
        self.dispatches = 0
        self.sampled = 0
        self.device_ns = 0
        #: samples whose bracket held an nvcc build
        self.compile_ns = 0
        self.builds = 0
        self.build_ns = 0
        #: analytic cost: None = not yet taken, {} = not available
        self.cost: Optional[dict] = None
        self._hist = [0] * (len(TIME_BUCKETS) + 1)
        #: unresolved CUDA event pairs of sampled entries made outside a
        #: profiled query (a profiled query resolves its own)
        self._pending: "collections.deque" = \
            collections.deque(maxlen=MAX_PENDING)

    # -- recording -----------------------------------------------------------
    def note_build(self, ns: int) -> None:
        with self._lock:
            self.builds += 1
            self.build_ns += int(ns)

    def annotate(self, meta: dict) -> None:
        """Attach dispatch-site metadata (label, owning exec, fused
        member names).  Idempotent per owner."""
        oid = meta.get("owner_id")
        with self._lock:
            if meta.get("label"):
                self.label = meta["label"]
            if meta.get("members"):
                self.members = list(meta["members"])
            if oid is not None and oid not in self.owners:
                self.owners[oid] = str(meta.get("owner", "?"))
                while len(self.owners) > MAX_OWNERS:
                    self.owners.popitem(last=False)

    def set_cost(self, cost: dict) -> None:
        with self._lock:
            if self.cost is None:
                self.cost = dict(cost)

    def observe(self, dt_ns: int) -> None:
        """Fold one resolved sample into the histogram and the
        telemetry per-family counters."""
        sec = dt_ns / 1e9
        idx = len(TIME_BUCKETS)
        for i, b in enumerate(TIME_BUCKETS):
            if sec <= b:
                idx = i
                break
        with self._lock:
            self.sampled += 1
            self.device_ns += dt_ns
            self._hist[idx] += 1
        from spark_rapids_tpu_torch.utils import telemetry as T
        T.note_kernel_sample(self.family, sec)

    def note_compile(self, dt_ns: int) -> None:
        with self._lock:
            self.compile_ns += dt_ns

    def _park(self, sample: "_Sample") -> None:
        with self._lock:
            self._pending.append(sample)

    def resolve_pending(self) -> None:
        """Read the elapsed time of every parked event pair whose end
        event has completed (never waits)."""
        with self._lock:
            pend = list(self._pending)
            self._pending.clear()
        keep = []
        for s in pend:
            if s.end.query():
                self.observe(s.elapsed_ns())
            else:
                keep.append(s)
        if keep:
            with self._lock:
                self._pending.extendleft(reversed(keep))

    # -- views ---------------------------------------------------------------
    def mean_ns(self) -> float:
        with self._lock:
            return self.device_ns / self.sampled if self.sampled else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fingerprint": self.fingerprint,
                "family": self.family,
                "label": self.label,
                "identity": repr(self.identity),
                "owners": list(self.owners.values()),
                "members": list(self.members) if self.members else None,
                "dispatches": self.dispatches,
                "sampled": self.sampled,
                "device_ns": self.device_ns,
                "compile_ms": round(
                    (self.compile_ns + self.build_ns) / 1e6, 3),
                "builds": self.builds,
                "cost": dict(self.cost) if self.cost else None,
                "hist": list(self._hist),
            }


class _Sample:
    """One sampled entry: a CUDA event pair, or a host-clock interval
    for a step on the CPU."""

    __slots__ = ("entry", "start", "end", "t0_ns", "host_ns", "tid")

    def __init__(self, entry, start, end, t0_ns, host_ns, tid):
        self.entry = entry
        self.start = start
        self.end = end
        self.t0_ns = t0_ns
        self.host_ns = host_ns
        self.tid = tid

    def elapsed_ns(self) -> int:
        if self.start is None:
            return self.host_ns
        return int(self.start.elapsed_time(self.end) * 1e6)


class _NullWatch:
    """Shared no-op watch: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def cost(self, *objs, flops: float = 0.0, nbytes: int = 0) -> None:
        pass

    def wants_cost(self) -> bool:
        return False


NULL_WATCH = _NullWatch()


class _Watch:
    """One entry of a kernel: counts it, claims it for the calling
    thread's query, and on a sampled entry brackets it with a CUDA event
    pair (or the host clock on the CPU); with `queued`, the pair's start
    waits behind a spin, so it brackets the kernel alone."""

    __slots__ = ("_entry", "_meta", "_cuda", "_queued", "_sampled",
                 "_start", "_end", "_t0", "_builds", "_tr")

    def __init__(self, entry: KernelEntry, meta, cuda: bool,
                 queued: bool = False):
        self._entry = entry
        self._meta = meta
        self._cuda = cuda
        self._queued = queued
        self._sampled = False
        self._start = None
        self._end = None
        self._t0 = 0
        self._builds = 0
        self._tr = None

    def wants_cost(self) -> bool:
        return _COST and self._entry.cost is None

    def cost(self, *objs, flops: float = 0.0, nbytes: int = 0) -> None:
        """The step's analytic cost, taken once per entry: `nbytes` plus
        the bytes of the tensors in `objs` (its inputs and outputs), and
        `flops` where the kernel has a formula."""
        if not self.wants_cost():
            return
        self._entry.set_cost({
            "bytes_accessed": float(int(nbytes) + tensor_bytes(*objs)),
            "flops": float(flops)})

    def __enter__(self):
        e = self._entry
        if self._meta is not None:
            e.annotate(self._meta)
        with e._lock:
            e.dispatches += 1
            n = e.dispatches
        from spark_rapids_tpu_torch.utils import profile as P
        self._tr = P.tracer()
        kl = getattr(self._tr, "kernels", None)
        if kl is not None and self._meta is not None \
                and self._meta.get("owner_id") is not None:
            kl.claim(e, self._meta["owner_id"])
        self._sampled = n == 1 or _RATE <= 1 or n % _RATE == 0
        if self._sampled:
            from spark_rapids_tpu_torch.ops import cuda_build
            self._builds = cuda_build.build_count()
            if self._cuda:
                # both events made before the start is recorded: the pair
                # brackets as little host work as it can
                import torch
                self._start = torch.cuda.Event(enable_timing=True)
                self._end = torch.cuda.Event(enable_timing=True)
                if self._queued:
                    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
                self._start.record()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc):
        e = self._entry
        kl = getattr(self._tr, "kernels", None)
        if not self._sampled or exc_type is not None:
            if kl is not None:
                kl.note(e, None)
            return False
        end = None
        if self._cuda:
            end = self._end
            end.record()
        host_ns = time.perf_counter_ns() - self._t0
        from spark_rapids_tpu_torch.ops import cuda_build
        if cuda_build.build_count() != self._builds:
            # an nvcc build ran inside the bracket: compile, not device
            # time
            e.note_compile(host_ns)
            if kl is not None:
                kl.note(e, None)
            return False
        s = _Sample(e, self._start, end, self._t0, host_ns,
                    threading.get_native_id())
        if kl is not None:
            kl.note(e, s)
        elif self._cuda:
            e._park(s)
        else:
            e.observe(host_ns)
        return False


# ---------------------------------------------------------------------------
def entry_for(identity: tuple) -> KernelEntry:
    with _LOCK:
        e = _CATALOG.get(identity)
        if e is None:
            e = _CATALOG[identity] = KernelEntry(identity)
        return e


def watch(identity: tuple, meta: Optional[dict] = None,
          device=None, queued: bool = False):
    """The context one entry of the kernel `identity` runs in: the
    shared null context while attribution is off.  `device` is the
    step's device (a CUDA device samples with events, anything else with
    the host clock); `queued` puts a sampled entry's start event behind
    a spin (one kernel launch inside the context)."""
    if not _ENABLED:
        return NULL_WATCH
    cuda = device is not None and getattr(device, "type", device) == "cuda"
    return _Watch(entry_for(identity), meta, cuda, queued)


def hand_watch(name: str, shape: tuple, device):
    """The watch of one launch of the hand-written CUDA kernel `name`
    (csrc/<name>.cu) at `shape`, its sampled time the kernel's alone.
    Take its cost (`wants_cost`/`cost`) before entering it: a cost that
    reads the device syncs the host, which the bracket must not hold."""
    if not _ENABLED:
        return NULL_WATCH
    return watch(((HAND_SCOPE, name), (name,) + tuple(shape)),
                 {"label": name}, device, queued=True)


def catalog() -> list:
    """Snapshot of every catalog entry (process lifetime), with the
    samples parked outside profiled queries resolved where complete."""
    with _LOCK:
        entries = list(_CATALOG.values())
    for e in entries:
        e.resolve_pending()
    return [e.snapshot() for e in entries]


def catalog_size() -> int:
    with _LOCK:
        return len(_CATALOG)


def family_device_seconds() -> dict:
    """{family: cumulative SAMPLED device seconds} across the catalog
    (the pull-side mirror of telemetry's kernel_device_seconds_total
    push counter)."""
    with _LOCK:
        entries = list(_CATALOG.values())
    out: dict = {}
    for e in entries:
        with e._lock:
            if e.device_ns:
                out[e.family] = out.get(e.family, 0.0) + e.device_ns / 1e9
    return out


def hand_kernel_totals(name: str) -> dict:
    """{launches, sampled, device_ns, mean_ms} over every catalog entry
    of the hand kernel `name`, and per shape."""
    with _LOCK:
        entries = [e for ident, e in _CATALOG.items()
                   if ident[0] == (HAND_SCOPE, name)]
    for e in entries:
        e.resolve_pending()
    rows = [e.snapshot() for e in entries]
    launches = sum(r["dispatches"] for r in rows)
    sampled = sum(r["sampled"] for r in rows)
    ns = sum(r["device_ns"] for r in rows)
    return {"launches": launches, "sampled": sampled, "device_ns": ns,
            "mean_ms": ns / sampled / 1e6 if sampled else 0.0,
            "entries": rows}


# ---------------------------------------------------------------------------
class QueryKernelLedger:
    """Per-query kernel attribution (created on the QueryTracer like
    the movement ledger): which kernels THIS query entered, how often,
    and the device time its sampled entries measured — isolated from
    every concurrent query sharing the same catalog entries."""

    def __init__(self, query_id: str, t_origin: int):
        self.query_id = query_id
        self.t_origin = t_origin
        self._lock = threading.Lock()
        #: entry -> [dispatches, sampled, device_ns]
        self._stats: "collections.OrderedDict" = collections.OrderedDict()
        #: owner exec_id -> [entry, ...] claims from this query's steps
        self._owners: dict = {}
        #: unresolved samples, in entry order
        self._pending: list = []
        #: (ts_ns, dur_ns, fingerprint, label, tid) Perfetto samples
        self._samples: "collections.deque" = \
            collections.deque(maxlen=MAX_QUERY_SAMPLES)
        self.resolved = False

    def note(self, entry: KernelEntry, sample: Optional[_Sample]) -> None:
        with self._lock:
            st = self._stats.get(entry)
            if st is None:
                st = self._stats[entry] = [0, 0, 0]
            st[0] += 1
            if sample is not None:
                self._pending.append(sample)

    def claim(self, entry: KernelEntry, owner_id: int) -> None:
        with self._lock:
            lst = self._owners.setdefault(owner_id, [])
            if entry not in lst:
                lst.append(entry)

    def resolve(self) -> None:
        """Read every sample's elapsed time: called once, at end_query.
        A CUDA sample set waits on its last event first (one host sync,
        accounted as ``kernelprof.resolve``)."""
        with self._lock:
            pend, self._pending = self._pending, []
            self.resolved = True
        last = None
        for s in pend:
            if s.end is not None:
                last = s
        if last is not None:
            from spark_rapids_tpu_torch.utils import checks as CK
            # events of one device complete in stream order per stream;
            # waiting on each end event costs nothing past the first
            for s in pend:
                if s.end is not None and not s.end.query():
                    s.end.synchronize()
            CK.note_host_sync("kernelprof.resolve")
        for s in pend:
            dt = s.elapsed_ns()
            s.entry.observe(dt)
            with self._lock:
                st = self._stats[s.entry]
                st[1] += 1
                st[2] += dt
                self._samples.append(
                    (s.t0_ns - self.t_origin, dt, s.entry.fingerprint,
                     s.entry.label, s.tid))

    def samples(self) -> list:
        with self._lock:
            return list(self._samples)

    def totals(self) -> dict:
        """{fingerprint: (dispatches, sampled, device_ns)} (tests)."""
        with self._lock:
            return {e.fingerprint: tuple(st)
                    for e, st in self._stats.items()}

    # -- the report ----------------------------------------------------------
    def report(self, conf=None) -> list:
        """One row per kernel this query entered, hottest first:
        entry counts, estimated cumulative device time (sampled mean x
        entries; the process-wide mean backstops kernels this query
        never sampled), compile ms, analytic cost, achieved GFLOP/s /
        GB/s, and the roofline fraction with whichever resource
        binds."""
        if not self.resolved:
            self.resolve()
        from spark_rapids_tpu_torch.utils import roofline as RL
        peak_gf = RL.peak_gflops(conf)
        hbm = RL.hbm_gbps(conf)
        with self._lock:
            items = [(e, list(st)) for e, st in self._stats.items()]
            owners = {oid: list(es) for oid, es in self._owners.items()}
        entry_owner: dict = {}
        for oid, es in owners.items():
            for e in es:
                entry_owner.setdefault(e, oid)
        rows = []
        for e, (disp, sampled, ns) in items:
            mean = (ns / sampled) if sampled else e.mean_ns()
            est_ns = mean * disp
            snap = e.snapshot()
            row = {
                "fingerprint": e.fingerprint,
                "family": e.family,
                "label": e.label,
                "identity": snap["identity"],
                "owner_id": entry_owner.get(e),
                "owners": snap["owners"],
                "members": snap["members"],
                "dispatches": disp,
                "sampled": sampled,
                "device_ms": round(est_ns / 1e6, 3),
                "avg_ms": round(mean / 1e6, 4),
                "compile_ms": snap["compile_ms"],
            }
            cost = snap["cost"]
            if cost and est_ns > 0:
                est_s = est_ns / 1e9
                flops = cost.get("flops", 0.0) * disp
                byts = cost.get("bytes_accessed", 0.0) * disp
                row["flops_per_dispatch"] = cost.get("flops", 0.0)
                row["bytes_per_dispatch"] = cost.get("bytes_accessed",
                                                     0.0)
                gf = flops / est_s / 1e9
                gb = byts / est_s / 1e9
                row["gflops"] = round(gf, 3)
                row["gbps"] = round(gb, 3)
                cf = gf / peak_gf if peak_gf > 0 else 0.0
                mf = gb / hbm if hbm > 0 else 0.0
                row["roofline_pct"] = round(100.0 * max(cf, mf), 3)
                row["bound"] = "compute" if cf >= mf else "memory"
            rows.append(row)
        rows.sort(key=lambda r: r["device_ms"], reverse=True)
        return rows


def format_report(rows: list, top_n: int = 12) -> str:
    """Human rendering for the QueryProfile's '-- kernels --' section."""
    if not rows:
        return "<no kernel dispatches attributed>"
    total_ms = sum(r["device_ms"] for r in rows)
    lines = [f"attributed device time: {total_ms:.1f} ms over "
             f"{sum(r['dispatches'] for r in rows)} dispatches "
             f"({len(rows)} kernels, top {min(top_n, len(rows))})"]
    for r in rows[:top_n]:
        roof = (f"  {r['gflops']:.1f} GF/s {r['gbps']:.2f} GB/s "
                f"{r['roofline_pct']:.2f}% roofline ({r['bound']})"
                if "roofline_pct" in r else "")
        owner = f"  <- {r['owners'][0]}" if r["owners"] else ""
        members = (f" [{'+'.join(r['members'])}]"
                   if r["members"] else "")
        lines.append(
            f"  {r['device_ms']:9.1f} ms  x{r['dispatches']:<5d} "
            f"(avg {r['avg_ms']:.2f} ms, compile "
            f"{r['compile_ms']:.0f} ms)  {r['fingerprint']} "
            f"{r['label']}{members}{roof}{owner}")
    return "\n".join(lines)
