"""spark_rapids_tpu_torch's engine-wide telemetry (utils/telemetry.py)
against spark_rapids_tpu's: twins of the 17 tests of
tests/test_telemetry.py, at its scale (TPC-H, SCALE = 400, seed 11,
the TPC bench conf).

Held against the reference: the registry's metric names (the Prometheus
text of both packages' default wiring carries the same series), the
utilization causes, and the query results.  The port has no kernel
cache: its `tpu_rapids_kernel_cache_*` gauges read the hand-written CUDA
kernels' builds, which are 0 on the CPU where these tests run, so the
storm twin checks that series is present, not above 0.
"""
import functools
import json
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
from pandas.testing import assert_frame_equal

from parity import compare_frames
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.models.tpch_bench import BENCH_CONF, run_query
from spark_rapids_tpu_torch.models.tpch_data import gen_tables
from spark_rapids_tpu_torch.utils import profile as P
from spark_rapids_tpu_torch.utils import telemetry as T
from test_torch_profile import reset_observability
from test_torch_tpcds import one_torch_thread  # noqa: F401 — fixture

SCALE = 400


@functools.lru_cache(maxsize=None)
def _tables():
    return gen_tables(np.random.default_rng(11), SCALE)


@pytest.fixture(autouse=True)
def _telemetry_cleanup(one_torch_thread):  # noqa: F811
    reset_observability()
    yield
    reset_observability()


def _conf(**extra) -> C.RapidsConf:
    settings = dict(BENCH_CONF)
    settings.update({k.replace("__", "."): v for k, v in extra.items()})
    return C.RapidsConf(settings)


def _run(q, conf, **kw):
    return run_query(q, _tables(), device="cpu", conf=conf, **kw)


def _tstart(**extra) -> T.Telemetry:
    return T.start(_conf(**{
        "spark.rapids.sql.telemetry.enabled": True,
        "spark.rapids.sql.telemetry.samplePeriodMs": 10.0,
        **{k.replace("__", "."): v for k, v in extra.items()}}))


# ---------------------------------------------------------------------------
# registry semantics
def test_registry_counter_gauge_histogram():
    r = T.MetricsRegistry()
    c = r.counter("t_c_total", "a counter")
    c.inc()
    c.inc(2)
    lc = r.counter("t_lc_total", "labelled counter", label="cause")
    lc.inc(1, "busy")
    lc.inc(3, "idle")
    r.gauge("t_g", "a gauge", fn=lambda: 7)
    r.gauge("t_lab", "labelled gauge", fn=lambda: {"a": 1, "b": 2},
            label="k")
    h = r.histogram("t_h_seconds", "a histogram", (0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = r.snapshot()
    assert snap["t_c_total"] == 3
    assert snap["t_lc_total{cause=busy}"] == 1
    assert snap["t_lc_total{cause=idle}"] == 3
    assert snap["t_g"] == 7
    assert snap["t_lab{k=a}"] == 1 and snap["t_lab{k=b}"] == 2
    assert snap["t_h_seconds_count"] == 3
    assert snap["t_h_seconds_sum"] == pytest.approx(5.55)
    assert r.counter("t_c_total", "other help") is c
    g = r.gauge("t_set", "set gauge")
    g.set(42)
    assert r.snapshot()["t_set"] == 42


def test_broken_gauge_does_not_break_scrape():
    r = T.MetricsRegistry()

    def boom():
        raise RuntimeError("probe died")

    r.gauge("t_broken", "raises", fn=boom)
    r.gauge("t_ok", "fine", fn=lambda: 1)
    text = r.prometheus_text()
    assert "t_ok 1" in text
    assert "t_broken" not in [ln.split(" ")[0] for ln in text.splitlines()
                              if not ln.startswith("#")]
    assert r.snapshot()["t_ok"] == 1


# ---------------------------------------------------------------------------
# Prometheus exposition-format validity
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"\})?'
    r" (-?[0-9.+e(inf)(nan)]+|[0-9]+)$", re.IGNORECASE)


def parse_prom(text: str) -> dict:
    """{name or name{label="v"}: float} for every sample line; raises
    on a malformed line."""
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = _SAMPLE_RE.match(ln)
        assert m, f"malformed exposition line: {ln!r}"
        out[m.group(1) + (m.group(2) or "")] = float(ln.rsplit(" ", 1)[1])
    return out


def test_prometheus_exposition_valid():
    r = T.MetricsRegistry()
    r.counter("t_c_total", "counter help\nwith newline").inc(5)
    r.gauge("t_g", "gauge", fn=lambda: 1.5)
    r.gauge("t_edges", "per-edge", fn=lambda: {"upload": 10, "wire": 3},
            label="edge")
    h = r.histogram("t_h_seconds", "hist", (0.1, 1.0, 10.0))
    for v in (0.05, 0.05, 0.5, 20.0):
        h.observe(v)
    text = r.prometheus_text()
    samples = parse_prom(text)
    assert samples["t_c_total"] == 5
    assert samples["t_g"] == 1.5
    assert samples['t_edges{edge="upload"}'] == 10
    assert "# TYPE t_c_total counter" in text
    assert "# HELP t_c_total counter help\\nwith newline" in text
    assert "# TYPE t_h_seconds histogram" in text
    buckets = [samples[f't_h_seconds_bucket{{le="{le}"}}']
               for le in ("0.1", "1", "10")]
    assert buckets == sorted(buckets) == [2, 3, 3]
    assert samples['t_h_seconds_bucket{le="+Inf"}'] == 4
    assert samples["t_h_seconds_count"] == 4
    assert samples["t_h_seconds_sum"] == pytest.approx(20.6)


# ---------------------------------------------------------------------------
# utilization sampler
def test_sampler_attribution_sums_to_100():
    from spark_rapids_tpu.utils import telemetry as RT
    assert T.CAUSES == RT.CAUSES
    t = _tstart()
    _run(1, _conf())
    time.sleep(0.2)
    s = t.utilization_summary()
    assert s["samples"] > 5
    total = sum(v for k, v in s.items() if k != "samples")
    assert 99.0 <= total <= 101.0, s
    assert all(k in T.CAUSES or k == "samples" for k in s)


def test_sampler_idle_when_nothing_runs():
    t = _tstart()
    time.sleep(0.3)
    assert T.active_queries() == 0
    assert t.utilization_summary().get("idle", 0) > 50.0


def test_timeline_bounded():
    t = _tstart(**{"spark.rapids.sql.telemetry.timelineSize": 16,
                   "spark.rapids.sql.telemetry.samplePeriodMs": 5.0})
    time.sleep(0.5)
    tl = t.utilization_timeline()
    assert 0 < len(tl) <= 16
    assert t.utilization_summary()["samples"] >= len(tl)


# ---------------------------------------------------------------------------
# live scrape during a concurrent q1/q5 storm
def test_live_scrape_during_storm():
    from spark_rapids_tpu import config as RC
    from spark_rapids_tpu.utils import telemetry as RT
    t = T.start(_conf(**{"spark.rapids.sql.telemetry.enabled": True,
                         "spark.rapids.sql.telemetry.samplePeriodMs": 10.0}),
                http_port=0)
    conf = _conf(**{"spark.rapids.sql.profile.enabled": True})
    expected = {q: _run(q, _conf()) for q in (1, 5)}
    mix = [1, 5, 1, 5, 1, 5, 1, 5]
    results = [None] * len(mix)
    errors = []
    storm_live = threading.Event()

    def worker(i, q):
        try:
            storm_live.set()
            results[i] = _run(q, conf)
        except BaseException as e:  # noqa: BLE001
            errors.append((i, e))

    mark = t.utilization_counts()
    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(i, q))
               for i, q in enumerate(mix)]
    for th in threads:
        th.start()
    storm_live.wait(10.0)
    scraped = []
    url = f"http://127.0.0.1:{t.http_port}/metrics"
    while any(th.is_alive() for th in threads):
        scraped.append(urllib.request.urlopen(url, timeout=10).read()
                       .decode())
        time.sleep(0.05)
    for th in threads:
        th.join(120)
    wall = time.time() - t0
    assert not errors, errors
    for i, q in enumerate(mix):
        assert_frame_equal(results[i].reset_index(drop=True),
                           expected[q].reset_index(drop=True))
    if not scraped:
        scraped.append(urllib.request.urlopen(url, timeout=10).read()
                       .decode())
    samples = parse_prom(scraped[-1])
    assert samples["tpu_rapids_hbm_budget_bytes"] > 0
    for name in ("tpu_rapids_hbm_admitted_bytes",
                 "tpu_rapids_semaphore_max_concurrent",
                 "tpu_rapids_scheduler_queue_depth",
                 "tpu_rapids_kernel_cache_entries"):
        assert name in samples, name
    during = t.utilization_summary(baseline=mark)
    # a quarter of the nominal tick count, where the reference asks for
    # half: the sampler thread wins the interpreter lock from eight CPU
    # sessions and the scraper, which on a loaded test box delays its
    # ticks (82 of a nominal 206 in one run beside five other workers)
    assert during["samples"] >= max(5, 0.25 * wall / 0.01), during
    assert sum(v for k, v in during.items() if k != "samples") >= 95.0
    assert all(k in T.CAUSES or k == "samples" for k in during)
    assert during.get("idle", 0.0) < 50.0, during
    # the default wiring exports the reference's series, name for name
    rt = RT.Telemetry(RC.RapidsConf({}), http_port=None)
    rt._register_default_metrics()
    assert {m.name for m in t.registry.metrics()} >= \
        {m.name for m in rt.registry.metrics()}


def test_http_endpoint_telemetry_json_and_404():
    t = T.start(_conf(**{"spark.rapids.sql.telemetry.enabled": True,
                         "spark.rapids.sql.telemetry.samplePeriodMs": 10.0}),
                http_port=0)
    base = f"http://127.0.0.1:{t.http_port}"
    snap = json.loads(urllib.request.urlopen(base + "/telemetry",
                                             timeout=5).read())
    assert set(snap) >= {"gauges", "utilization", "active_queries",
                         "slow_queries"}
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=5)
    assert ei.value.code == 404


# ---------------------------------------------------------------------------
# slow-query log
def test_slow_query_log_fingerprint_aggregation():
    t = _tstart()
    conf = _conf(**{"spark.rapids.sql.profile.enabled": True})
    for _ in range(3):
        _run(1, conf)
    _run(5, conf)
    log = t.slow_query_log()
    assert len(log) == 2
    by_count = {e["count"]: e for e in log}
    assert set(by_count) == {3, 1}
    q1e = by_count[3]
    assert 0 < q1e["p50_ms"] <= q1e["p95_ms"] <= q1e["max_ms"]
    assert isinstance(q1e["top_idle_cause"], str)
    assert q1e["fingerprint"] != by_count[1]["fingerprint"]
    assert sum(e["count"] for e in log) == 4


def test_slow_query_log_bounded():
    t = _tstart(**{"spark.rapids.sql.telemetry.slowQueryLog.size": 2})
    conf = _conf(**{"spark.rapids.sql.profile.enabled": True})
    _run(1, conf)
    _run(5, conf)
    _run(1, conf, num_partitions=4)
    assert len(t.slow_query_log()) == 2


# ---------------------------------------------------------------------------
# movement edge bytes reach the process-wide gauge
def test_movement_edge_totals_exported():
    from spark_rapids_tpu_torch.utils import movement as MV
    t = _tstart()
    before = MV.process_edge_totals().get("readback", 0)
    _run(1, _conf(**{"spark.rapids.sql.profile.enabled": True}))
    assert MV.process_edge_totals().get("readback", 0) > before
    samples = parse_prom(t.registry.prometheus_text())
    assert samples['tpu_rapids_movement_bytes_total{edge="readback"}'] > 0


# ---------------------------------------------------------------------------
# event-log rotation
def test_rotating_append_unit(tmp_path):
    path = str(tmp_path / "log.jsonl")
    line = "x" * 99 + "\n"
    for _ in range(10):
        P.rotating_append(path, line, max_bytes=250, keep=2)
    assert os.path.getsize(path) <= 250
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")
    path2 = str(tmp_path / "log2.jsonl")
    for _ in range(10):
        P.rotating_append(path2, line, max_bytes=0, keep=2)
    assert os.path.getsize(path2) == 1000
    assert not os.path.exists(path2 + ".1")


def test_event_log_rotation_under_queries(tmp_path):
    path = str(tmp_path / "events.jsonl")
    max_bytes = 30_000
    conf = _conf(**{
        "spark.rapids.sql.profile.enabled": True,
        "spark.rapids.sql.profile.eventLog.path": path,
        "spark.rapids.sql.profile.eventLog.maxBytes": max_bytes,
        "spark.rapids.sql.profile.eventLog.keepFiles": 2})
    for _ in range(6):
        _run(1, conf)
    assert os.path.exists(path)
    assert os.path.exists(path + ".1"), "rotation never happened"
    assert not os.path.exists(path + ".3")
    sizes = [os.path.getsize(p) for p in (path, path + ".1")
             if os.path.exists(p)]
    assert all(s <= max_bytes for s in sizes)
    with open(path + ".1") as f:
        first = json.loads(f.readline())
    assert "query_id" in first and "kind" in first


def test_telemetry_snapshot_rides_event_log(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _tstart(**{"spark.rapids.sql.profile.eventLog.path": path,
               "spark.rapids.sql.telemetry.snapshotPeriodS": 0.05,
               "spark.rapids.sql.telemetry.samplePeriodMs": 10.0})
    time.sleep(0.4)
    assert os.path.exists(path)
    recs = [json.loads(ln) for ln in open(path)]
    assert "telemetry_snapshot" in [r["kind"] for r in recs]
    rec = next(r for r in recs if r["kind"] == "telemetry_snapshot")
    assert "gauges" in rec and "utilization" in rec


# ---------------------------------------------------------------------------
# watchdog dump embeds a telemetry snapshot
def test_watchdog_dump_embeds_telemetry():
    from spark_rapids_tpu_torch.utils.watchdog import build_dump
    _tstart()
    _run(1, _conf())
    time.sleep(0.05)
    dump = build_dump()
    assert "-- telemetry --" in dump
    assert "tpu_rapids_hbm_budget_bytes" in dump
    assert "utilization:" in dump
    T.stop()
    assert "<telemetry disabled>" in build_dump()


# ---------------------------------------------------------------------------
# disabled path: single global read, no server, bit-exact parity
def test_disabled_path_and_bit_exact_parity():
    from spark_rapids_tpu.models.tpch_bench import run_query as rrun
    from spark_rapids_tpu import config as RC
    assert T.live() is None
    conf_off = _conf()
    off1 = _run(1, conf_off)
    assert T.live() is None
    assert T.maybe_start(conf_off) is None
    assert T.prometheus_text() == ""
    assert T.snapshot() is None
    T.note_query_profile(None, None)
    n0 = T.active_queries()
    T.note_query_begin()
    T.note_query_end()
    assert T.active_queries() == n0
    on = _run(1, _conf(**{"spark.rapids.sql.telemetry.enabled": True}))
    assert T.live() is not None
    off2 = _run(1, conf_off)
    assert_frame_equal(off1.reset_index(drop=True),
                       on.reset_index(drop=True))
    assert_frame_equal(off1.reset_index(drop=True),
                       off2.reset_index(drop=True))
    compare_frames(rrun(1, gen_tables(np.random.default_rng(11), SCALE),
                        engine="tpu", conf=RC.RapidsConf(dict(BENCH_CONF))),
                   on, "q1")


def test_active_query_counter_balanced():
    _tstart()
    assert T.active_queries() == 0
    _run(1, _conf())
    assert T.active_queries() == 0
