"""spark_rapids_tpu_torch's planner nodes CpuSortAggregate,
CpuShuffleExchange (hash and round-robin), CpuSortMergeJoin and
CpuCachedColumnar, and its shims (the loader and the methods the I/O
layer and the exchange call), against spark_rapids_tpu's: twins of
tests/test_plan_overrides.py's test_sort_aggregate_replaced_with_hash_agg,
test_shuffle_exchange_parity, the three test_sort_merge_join_* cases and
test_cached_columnar_uploads_without_row_pivot, and of the
tests/test_shims.py cases of those methods; then TPC-H Q3 over Parquet
files the port wrote, against the JAX package's CPU engine over the same
files.

Results exact but for floats (rtol 1e-6, compare_frames' 1e-5 for Q3,
as the reference's tests hold them); exec trees class for class."""
import os
import types

import numpy as np
import pandas as pd
import pytest
from parity import compare_frames

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import io as rio
from spark_rapids_tpu import shims as RSH
from spark_rapids_tpu.exec import sort as RSO
from spark_rapids_tpu.exprs import aggregates as RA
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.io import exec as RX
from spark_rapids_tpu.io import scan as RS
from spark_rapids_tpu.models import tpch_queries as RQ
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import io as pio
from spark_rapids_tpu_torch import shims as SH
from spark_rapids_tpu_torch.exec import sort as SO
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.joins import JoinType
from spark_rapids_tpu_torch.exprs import aggregates as A
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.io import exec as X
from spark_rapids_tpu_torch.io import scan as S
from spark_rapids_tpu_torch.models import tpch_bench as TB
from spark_rapids_tpu_torch.models import tpch_data as TD
from spark_rapids_tpu_torch.models import tpch_queries as Q
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O

REF = types.SimpleNamespace(C=RC, col=RE.col, lit=RE.lit, N=RN, A=RA,
                            SO=RSO, SH=RSH, io=rio, X=RX, S=RS)
PORT = types.SimpleNamespace(C=C, col=E.col, lit=E.lit, N=N, A=A, SO=SO,
                             SH=SH, io=pio, X=X, S=S)
BOTH = (REF, PORT)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch's CPU ops while the module runs."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jt(m):
    if m is PORT:
        return JoinType
    from spark_rapids_tpu.exec.joins import JoinType as RJ
    return RJ


def conf(m, **kv):
    return m.C.RapidsConf({k.replace("__", "."): v for k, v in kv.items()})


def run(m, plan, c=None):
    c = c or conf(m)
    if m is REF:
        out = RO.accelerate(plan, c)
        return RO.collect(out, c), out
    out = O.accelerate(plan, c, device="cpu")
    return O.collect(out, c), out


def _df():
    return pd.DataFrame({
        "a": np.arange(10, dtype=np.int64),
        "b": np.array([1.5, 2.5, np.nan, 4.0, 5.0, -1.0, 0.0, 7.5, 8.0,
                       9.25]),
        "s": [None if i % 4 == 0 else f"s{i}" for i in range(10)],
    })


def _right():
    return pd.DataFrame({"k": np.array([0, 1, 2, 9, 9], np.int64),
                         "v": ["x", "y", "z", "w", "q"]})


def same(want, got, sort_by=None):
    if sort_by:
        want = want.sort_values(sort_by, ignore_index=True)
        got = got.sort_values(sort_by, ignore_index=True)
    assert list(want.columns) == list(got.columns)
    assert len(want) == len(got)
    for name in want.columns:
        w, g = want[name], got[name]
        wn, gn = w.isna().to_numpy(), g.isna().to_numpy()
        np.testing.assert_array_equal(wn, gn, err_msg=f"nulls {name}")
        wv, gv = w[~wn].to_numpy(), g[~gn].to_numpy()
        if w.dtype == object or g.dtype == object:
            assert list(wv) == list(gv), name
        else:
            np.testing.assert_allclose(np.asarray(wv, float),
                                       np.asarray(gv, float), rtol=1e-6,
                                       err_msg=name)


def both_same(build, c=None, sort_by=None):
    """build(m) -> plan: the reference's CPU engine, the reference
    accelerated and the port accelerated agree.  Returns (the port's
    accelerated plan, the reference's)."""
    want = build(REF).collect()
    ref_got, ref_plan = run(REF, build(REF), c and c(REF))
    got, plan = run(PORT, build(PORT), c and c(PORT))
    same(want, ref_got, sort_by)
    same(ref_got, got, sort_by)
    return plan, ref_plan


def _names(plan, acc=None):
    """Class names of the device execs, in tree order."""
    acc = [] if acc is None else acc
    if type(plan).__module__.startswith(("spark_rapids_tpu.exec",
                                         "spark_rapids_tpu.shuffle",
                                         "spark_rapids_tpu.plan.trans",
                                         "spark_rapids_tpu.plan.fusion")) \
            or isinstance(plan, TpuExec):
        acc.append(type(plan).__name__)
        for c in plan.children:
            _names(c, acc)
    return acc


# -- the planner nodes -------------------------------------------------------
def test_sort_aggregate_replaced_with_hash_agg():
    def build(m):
        return m.N.CpuSortAggregate(
            [(m.col("a") % 3).alias("k")],
            [m.A.Sum(m.col("a")).alias("sa"),
             m.A.Count(m.col("s")).alias("cs")],
            m.N.CpuSource.from_pandas(_df(), num_partitions=3))
    plan, ref_plan = both_same(build, sort_by=["k"])
    names = _names(plan)
    assert names == _names(ref_plan)
    assert names.count("HashAggregateExec") == 2
    assert "SortAggregate" not in " ".join(names)
    # the CPU engine's sort aggregate returns its groups in key order
    cpu = build(PORT).collect()
    assert list(cpu["k"]) == [0, 1, 2]


@pytest.mark.parametrize("kind", ["hash", "roundrobin"])
def test_shuffle_exchange_parity(kind):
    def build(m):
        exprs = (m.col("a"),) if kind == "hash" else ()
        return m.N.CpuShuffleExchange(
            m.N.PartitioningSpec(kind, 4, exprs),
            m.N.CpuSource.from_pandas(_df(), num_partitions=2))
    plan, ref_plan = both_same(build, sort_by=["a"])
    assert _names(plan) == _names(ref_plan)
    assert plan.output_partition_count() == 4
    # every row lands in exactly one of the four partitions
    parts = [sorted(int(v) for b in it
                    for v in b.column("a").to_numpy(b.num_rows)[0])
             for it in plan.execute_partitions()]
    assert sorted(v for p in parts for v in p) == list(range(10))
    if kind == "roundrobin":
        # each of the two input batches deals its five rows in turn from
        # a random start, so no partition gets 2 rows more than another
        sizes = [len(p) for p in parts]
        assert max(sizes) - min(sizes) <= 2


def _smj_plan(m, n_parts=2):
    left = m.N.CpuSort([m.SO.asc(m.col("a"))],
                       m.N.CpuSource.from_pandas(_df(),
                                                 num_partitions=n_parts),
                       global_sort=False)
    right = m.N.CpuSort([m.SO.asc(m.col("k"))],
                        m.N.CpuSource.from_pandas(_right(),
                                                  num_partitions=n_parts),
                        global_sort=False)
    return m.N.CpuSortMergeJoin(_jt(m).INNER, [m.col("a")], [m.col("k")],
                                left, right)


def test_sort_merge_join_replaced_with_hash_join():
    plan, ref_plan = both_same(_smj_plan, sort_by=["a", "v"])
    names = _names(plan)
    assert names == _names(ref_plan)
    assert "HashJoinExec" in names
    # the SMJ input sorts are redundant for a hash join: stripped
    assert "SortExec" not in names


def test_sort_merge_join_keeps_unrelated_sort():
    """A sort that is not the join keys' ordering was not inserted for
    the merge, and survives the replacement."""
    def build(m):
        left = m.N.CpuSort([m.SO.asc(m.col("b"))],
                           m.N.CpuSource.from_pandas(_df(),
                                                     num_partitions=2),
                           global_sort=False)
        right = m.N.CpuSource.from_pandas(_right().iloc[:3],
                                          num_partitions=2)
        return m.N.CpuSortMergeJoin(_jt(m).INNER, [m.col("a")],
                                    [m.col("k")], left, right)
    plan, ref_plan = both_same(build, sort_by=["a", "v"])
    assert "SortExec" in _names(plan)
    assert _names(plan) == _names(ref_plan)


def test_sort_merge_join_conf_off_falls_back():
    outs = []
    for m in BOTH:
        c = conf(m, spark__rapids__sql__replaceSortMergeJoin__enabled=False)
        expected = _smj_plan(m).collect()
        got, plan = run(m, _smj_plan(m), c)
        (RO if m is REF else O).ExecutionPlanCapture.assert_did_fall_back(
            "CpuSortMergeJoin")
        compare_frames(expected, got, "smj-conf-off")
        outs.append(got)
    compare_frames(outs[0], outs[1], "smj-conf-off, both packages")


def test_cached_columnar_uploads_without_row_pivot():
    """A host-columnar (Arrow) cached source enters the device plan
    through HostColumnarToDeviceExec, with no row pivot."""
    df = pd.DataFrame({
        "a": np.arange(20, dtype=np.int64),
        "b": np.linspace(0, 1, 20),
        "s": [None if i % 5 == 0 else f"v{i}" for i in range(20)],
    })

    def build(m):
        cached = m.N.CpuCachedColumnar.from_pandas(df, num_partitions=3)
        return m.N.CpuProject(
            [(m.col("a") * 10).alias("x"), m.col("b"), m.col("s")],
            m.N.CpuFilter(m.col("a") >= 4, cached))
    plan, ref_plan = both_same(build, sort_by=["x"])
    names = _names(plan)
    assert names == _names(ref_plan)
    assert "HostColumnarToDeviceExec" in names
    assert "RowToColumnarExec" not in names


def test_collect_limit_exec():
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.exec.limit import (CollectLimitExec,
                                                   GlobalLimitExec)
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    df = _df()
    src = LocalBatchSource(
        [[batch_from_df(df.iloc[:6], N.schema_of_df(df), "cpu")],
         [batch_from_df(df.iloc[6:].reset_index(drop=True),
                        N.schema_of_df(df), "cpu")]],
        N.schema_of_df(df), device="cpu")
    ex = CollectLimitExec(7, src)
    assert isinstance(ex, GlobalLimitExec)
    assert ex.output_partition_count() == 1
    assert list(ex.collect().to_pandas()["a"]) == list(range(7))


# -- the shims: loader --------------------------------------------------------
def test_loader_resolves_every_supported_version():
    assert [p.__name__ for p in SH.ALL_SHIMS] == \
        [p.__name__ for p in RSH.ALL_SHIMS]
    for provider, rprovider in zip(SH.ALL_SHIMS, RSH.ALL_SHIMS):
        assert provider.VERSION_NAMES == rprovider.VERSION_NAMES
        for name in provider.VERSION_NAMES:
            assert type(SH.get_spark_shims(name)) is provider


def test_loader_unknown_version_raises():
    for m in BOTH:
        with pytest.raises(RuntimeError, match="3.2.0"):
            m.SH.get_spark_shims("3.2.0")


def test_loader_caches_instances():
    assert SH.get_spark_shims("3.0.1") is SH.get_spark_shims("3.0.1")


def test_databricks_detection_from_cluster_tag():
    for m in BOTH:
        c = conf(m, **{"spark.databricks.clusterUsageTags.clusterId":
                       "0001-x", "spark.rapids.tpu.sparkVersion": "3.0.0"})
        assert m.SH.detect_version(c) == "3.0.0-databricks"
        assert isinstance(m.SH.current_shims(c), m.SH.Spark300dbShims)


def test_default_version_is_301():
    for m in BOTH:
        assert isinstance(m.SH.current_shims(conf(m)), m.SH.Spark301Shims)


def test_databricks_without_db_shim_degrades_to_upstream():
    """A Databricks cluster tag on a base version with no -databricks
    provider does not break plan rewrites."""
    for m in BOTH:
        c = conf(m, **{"spark.databricks.clusterUsageTags.clusterId":
                       "0001-x", "spark.rapids.tpu.sparkVersion": "3.0.1"})
        assert m.SH.detect_version(c) == "3.0.1"
        assert isinstance(m.SH.current_shims(c), m.SH.Spark301Shims)


def test_shim_version_parse_and_order():
    for text in ("3.1.1-SNAPSHOT", "3.0.0", "3.1.0", "3.0.0-databricks"):
        v, rv = SH.ShimVersion.parse(text), RSH.ShimVersion.parse(text)
        assert (v.major, v.minor, v.patch, v.databricks, str(v)) == \
            (rv.major, rv.minor, rv.patch, rv.databricks, str(rv))
    v = SH.ShimVersion.parse("3.1.1-SNAPSHOT")
    assert (v.major, v.minor, v.patch) == (3, 1, 1)
    assert SH.ShimVersion.parse("3.0.0") < SH.ShimVersion.parse("3.1.0")
    assert SH.ShimVersion.parse("3.0.0-databricks").databricks


def test_register_external_provider():
    class CustomShims(SH.Spark301Shims):
        VERSION_NAMES = ("3.0.1-custom",)
    SH.register_provider(CustomShims)
    assert isinstance(SH.get_spark_shims("3.0.1-custom"), CustomShims)


# -- the shims: the ported methods --------------------------------------------
def test_file_partition_packing():
    files = [("a", 10), ("b", 200), ("c", 30), ("d", 5)]
    parts = SH.get_spark_shims("3.0.1").make_file_partitions(
        files, max_bytes=256, open_cost=8)
    assert parts == RSH.get_spark_shims("3.0.1").make_file_partitions(
        files, max_bytes=256, open_cost=8)
    assert sorted(f for p in parts for f, _ in p) == ["a", "b", "c", "d"]
    for p in parts:
        assert sum(sz + 8 for _, sz in p) <= 256 or len(p) == 1


def test_rebase_keys_and_defaults_per_version():
    for p, rp in zip(SH.ALL_SHIMS, RSH.ALL_SHIMS):
        s, rs = p(), rp()
        assert (s.parquet_rebase_read_key(), s.parquet_rebase_write_key(),
                s.parquet_rebase_default()) == \
            (rs.parquet_rebase_read_key(), rs.parquet_rebase_write_key(),
             rs.parquet_rebase_default())
        for mode in ("true", "false", "LEGACY", "corrected"):
            c = {s.parquet_rebase_read_key(): mode,
                 s.parquet_rebase_write_key(): mode}
            assert s.parquet_rebase_read_mode(C.RapidsConf(c)) == \
                rs.parquet_rebase_read_mode(RC.RapidsConf(c))
            assert s.parquet_rebase_write_mode(C.RapidsConf(c)) == \
                rs.parquet_rebase_write_mode(RC.RapidsConf(c))


def test_shuffle_exchange_constructor_drift():
    """3.0 exchanges always allow AQE coalescing; 3.1's
    ShuffleExchangeLike carries canChangeNumPartitions."""
    from spark_rapids_tpu_torch.exec.basic import LocalBatchSource
    from spark_rapids_tpu_torch.plan.transitions import batch_from_df
    from spark_rapids_tpu_torch.shuffle.partitioning import \
        RoundRobinPartitioning
    df = pd.DataFrame({"a": [1, 2]})
    src = LocalBatchSource([[batch_from_df(df, N.schema_of_df(df), "cpu")]],
                           N.schema_of_df(df), device="cpu")
    part = RoundRobinPartitioning(2)
    ex300 = SH.Spark300Shims().make_shuffle_exchange(
        part, src, can_change_num_partitions=False)
    assert ex300.can_change_num_partitions is True  # 3.0: no such flag
    ex310 = SH.Spark310Shims().make_shuffle_exchange(
        part, src, can_change_num_partitions=False)
    assert ex310.can_change_num_partitions is False
    assert sorted(ex310.collect().to_pandas()["a"]) == [1, 2]


def test_databricks_file_partitions_pack_whole_files():
    """Databricks' getPartitionSplitFiles packs whole files."""
    out = []
    for m in BOTH:
        files = [m.S.FileSplit(path=f"/f{i}", start=0, length=10_000_000,
                               file_size=10_000_000) for i in range(3)]
        for shim in (m.SH.Spark301Shims(), m.SH.Spark300dbShims()):
            out.append([[(s.path, s.start, s.length) for s in p.splits]
                        for p in shim.plan_file_partitions(
                            files, max_bytes=4_000_000, open_cost=10_000,
                            min_partitions=1)])
    assert out[:2] == out[2:]
    assert any(length < 10_000_000 for p in out[2] for _, _, length in p)
    assert all(length == 10_000_000 for p in out[3] for _, _, length in p)


def test_copy_scan_with_small_file_opt(tmp_path):
    pd.DataFrame({"a": [1, 2, 3]}).to_parquet(tmp_path / "x.parquet")
    sd = X.ScanDescription(str(tmp_path), "parquet",
                           conf=C.get_active_conf())
    exec_ = X.TpuFileSourceScanExec(sd, device="cpu")
    shims = SH.current_shims(C.get_active_conf())
    for enabled in (True, False):
        copied = shims.copy_scan_with_small_file_opt(exec_, enabled)
        assert copied.scan.small_file_opt is enabled
        assert copied.scan is not exec_.scan
        assert copied.device() == exec_.device()
        assert copied.collect().num_rows == 3
    # with the opt off each split reads through its OWN reader (no
    # cross-file coalescing): two files give two batches or more
    pd.DataFrame({"a": [4, 5]}).to_parquet(tmp_path / "y.parquet")
    counts = []
    for m in BOTH:
        sd2 = m.X.ScanDescription(str(tmp_path), "parquet",
                                  conf=m.C.get_active_conf())
        kw = {"device": "cpu"} if m is PORT else {}
        off = m.SH.current_shims(m.C.get_active_conf()) \
            .copy_scan_with_small_file_opt(
                m.X.TpuFileSourceScanExec(sd2, **kw), False)
        batches = [b for it in off.execute_partitions() for b in it]
        counts.append((sum(b.num_rows for b in batches), len(batches)))
    assert counts[0] == counts[1]
    assert counts[1][0] == 5 and counts[1][1] >= 2


def test_unknown_version_fails_with_supported_list():
    """An unknown version fails like the loader, naming the supported
    versions and the escape hatch."""
    for m in BOTH:
        with pytest.raises(RuntimeError) as ei:
            m.SH.get_spark_shims("3.0.9", conf=m.C.RapidsConf())
        msg = str(ei.value)
        assert "3.0.9" in msg and "3.0.2" in msg
        assert "allowUnknownSparkVersion" in msg


def test_unknown_version_conf_gated_nearest_minor_fallback():
    """With the gate, an unknown patch release falls back to the highest
    known shim of its minor line (3.0.9 -> 3.0.2); an unknown minor
    line still fails."""
    for m in BOTH:
        gated = m.C.RapidsConf(
            {"spark.rapids.tpu.allowUnknownSparkVersion": True})
        shims = m.SH.get_spark_shims("3.0.9", conf=gated)
        assert "3.0.2" in type(shims).VERSION_NAMES
        with pytest.raises(RuntimeError):
            m.SH.get_spark_shims("9.9.0", conf=gated)


def test_unknown_version_fallback_not_leaked_across_sessions():
    """A fallback cached by a gated session does not reach a later
    session with the gate unset."""
    for m in BOTH:
        gated = m.C.RapidsConf(
            {"spark.rapids.tpu.allowUnknownSparkVersion": True})
        shims = m.SH.get_spark_shims("3.0.8", conf=gated)
        assert "3.0.2" in type(shims).VERSION_NAMES
        with pytest.raises(RuntimeError):
            m.SH.get_spark_shims("3.0.8", conf=m.C.RapidsConf())
        assert m.SH.get_spark_shims("3.0.8", conf=gated) is shims


def test_unknown_version_hint_only_when_actionable():
    """The hint names the escape hatch only where it would help."""
    for m in BOTH:
        with pytest.raises(RuntimeError) as e1:
            m.SH.get_spark_shims("9.9.0", conf=m.C.RapidsConf())
        assert "allowUnknownSparkVersion" not in str(e1.value)
        gated = m.C.RapidsConf(
            {"spark.rapids.tpu.allowUnknownSparkVersion": True})
        with pytest.raises(RuntimeError) as e2:
            m.SH.get_spark_shims("9.9.1", conf=gated)
        assert "allowUnknownSparkVersion" not in str(e2.value)


# -- TPC-H Q3 over Parquet files ----------------------------------------------
def test_q3_over_parquet_matches_reference(tmp_path):
    """The port writes customer, orders and lineitem as Parquet through
    its writer (lineitem partitioned by l_returnflag), reads them back
    through read_parquet with the filters pushed into the scans, and
    runs Q3 on the CPU device: equal to the JAX package's CPU engine over
    the same files, and to the port over the in-memory frames."""
    tables = TD.gen_tables(np.random.default_rng(11), 3000)
    conf_ = C.RapidsConf(dict(TB.BENCH_CONF))
    srcs = TD.sources(tables, 2)
    for name, part_by in (("customer", ()), ("orders", ()),
                          ("lineitem", ("l_returnflag",))):
        res = O.collect(O.accelerate(pio.write(
            srcs[name], str(tmp_path / name), "parquet", part_by), conf_,
            device="cpu"), conf_)
        assert int(res["num_rows"][0]) == len(tables[name])
    assert os.path.isdir(tmp_path / "lineitem" / "l_returnflag=R")

    def files(io):
        return {n: io.read_parquet(str(tmp_path / n))
                for n in ("customer", "orders", "lineitem")}
    plan = O.accelerate(Q.QUERIES[3](files(pio), None), conf_,
                        device="cpu")
    got = O.collect(plan, conf_)
    scans = [n for n in _walk(plan) if isinstance(n, X.TpuFileSourceScanExec)]
    assert len(scans) == 3 and all(s.pushed_filter is not None
                                   for s in scans)
    # the scans read only the columns Q3 uses
    assert sorted(scans[-1].scan.data_schema.names) == \
        ["l_discount", "l_extendedprice", "l_orderkey", "l_shipdate"]
    ref = RQ.QUERIES[3](files(rio), None).collect()
    compare_frames(ref, got, "q3 over parquet vs the reference")
    assert list(got["l_orderkey"]) == list(ref["l_orderkey"])
    mem = TB.run_query(3, tables, device="cpu")
    compare_frames(mem, got, "q3 over parquet vs in memory")
    assert len(got) > 1


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)
