"""spark_rapids_tpu_torch's I/O layer (io/: split planning, hive
discovery, statistics pushdown, the parquet/ORC/CSV scans, the writers
and their commit protocol, the hybrid-calendar rebase) against
spark_rapids_tpu's: twins of all 35 tests of tests/test_io.py and of
tests/test_columnar.py's Arrow round trip.

Each test writes its files once, from a seeded numpy frame, and runs
them through both packages on the CPU (the port with device="cpu"):
integers, strings, dates, nulls, row counts and row-group choices
exact; floats at the reference test's own rtol 1e-6.  Where each
package writes, each writes its own directory from the same batch, and
the files must hold the same table."""
import datetime
import os
import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import config as RC
from spark_rapids_tpu import io as rio
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.exprs import base as RE
from spark_rapids_tpu.exprs import predicates as RP
from spark_rapids_tpu.io import exec as RX
from spark_rapids_tpu.io import pushdown as RPD
from spark_rapids_tpu.io import rebase as RRB
from spark_rapids_tpu.io import scan as RS
from spark_rapids_tpu.io import writer as RW
from spark_rapids_tpu.io.csv import CsvOptions as RCsvOptions
from spark_rapids_tpu.io.parquet import ParquetColumnarWriter as RPW
from spark_rapids_tpu.io.parquet import ParquetFormat as RPF
from spark_rapids_tpu.io.parquet import ParquetWriterOptions as RPWO
from spark_rapids_tpu.plan import nodes as RN
from spark_rapids_tpu.plan import overrides as RO
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import io as pio
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exprs import base as E
from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.io import exec as X
from spark_rapids_tpu_torch.io import pushdown as PD
from spark_rapids_tpu_torch.io import rebase as RB
from spark_rapids_tpu_torch.io import scan as S
from spark_rapids_tpu_torch.io import writer as W
from spark_rapids_tpu_torch.io.csv import CsvOptions
from spark_rapids_tpu_torch.io.parquet import (ParquetColumnarWriter,
                                               ParquetFormat,
                                               ParquetWriterOptions)
from spark_rapids_tpu_torch.plan import nodes as N
from spark_rapids_tpu_torch.plan import overrides as O

#: each package's names, so one builder makes the same plan of both
REF = types.SimpleNamespace(
    io=rio, T=RT, C=RC, col=RE.col, lit=RE.lit, N=RN, X=RX, S=RS, W=RW,
    PD=RPD, RB=RRB, P=RP, CsvOptions=RCsvOptions, Batch=RBatch,
    PW=RPW, PF=RPF, PWO=RPWO, gpu=False)
PORT = types.SimpleNamespace(
    io=pio, T=T, C=C, col=E.col, lit=E.lit, N=N, X=X, S=S, W=W, PD=PD,
    RB=RB, P=P, CsvOptions=CsvOptions, Batch=ColumnarBatch,
    PW=ParquetColumnarWriter, PF=ParquetFormat, PWO=ParquetWriterOptions,
    gpu=True)
BOTH = (REF, PORT)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch's CPU ops while the module runs (the
    inputs are small; with xdist's workers side by side a full OpenMP
    pool per worker spins against the others)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def conf(m, **kv):
    return m.C.RapidsConf({k.replace("__", "."): v for k, v in kv.items()})


def accel(m, plan, c=None):
    c = c or conf(m)
    if m is REF:
        return RO.accelerate(plan, c)
    return O.accelerate(plan, c, device="cpu")


def run(m, plan, c=None):
    c = c or conf(m)
    out = accel(m, plan, c)
    return (RO if m is REF else O).collect(out, c), out


def batch_of(m, df):
    """`df` as a batch of package m (the port's on the CPU)."""
    if m is REF:
        return RBatch.from_pandas(df)
    return ColumnarBatch.from_numpy(
        {c: (df[c].to_numpy(object) if df[c].dtype == object
             else df[c].to_numpy()) for c in df.columns},
        validity={c: df[c].notna().to_numpy() for c in df.columns},
        device="cpu")


def batch_np(m, data, schema):
    if m is REF:
        return RBatch.from_numpy(data, schema)
    return ColumnarBatch.from_numpy(data, schema, device="cpu")


def same(want: pd.DataFrame, got: pd.DataFrame, sort_by=None) -> None:
    """Equal frames: names, nulls, exact non-floats, floats rtol 1e-6."""
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
        if not (pd.api.types.is_numeric_dtype(w.dtype)
                and pd.api.types.is_numeric_dtype(g.dtype)):
            assert list(wv) == list(gv), f"column {name}"
        elif np.asarray(wv).dtype.kind == "f" or \
                np.asarray(gv).dtype.kind == "f":
            np.testing.assert_allclose(
                np.asarray(wv, float), np.asarray(gv, float), rtol=1e-6,
                err_msg=f"column {name}")
        else:
            np.testing.assert_array_equal(
                np.asarray(wv, np.int64), np.asarray(gv, np.int64),
                err_msg=f"column {name}")


def both_same(build, c=None, sort_by=None):
    """build(m) -> plan, run through both packages accelerated (and the
    reference's CPU engine, the reference test's golden): equal results.
    Returns the port's accelerated plan."""
    want = build(REF).collect()
    got_ref, _ = run(REF, build(REF), c and c(REF))
    got, plan = run(PORT, build(PORT), c and c(PORT))
    same(want, got_ref, sort_by)
    same(got_ref, got, sort_by)
    return plan


def _sample_df(n=100, seed=7):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "i": np.arange(n, dtype=np.int64),
        "f": rng.normal(size=n),
        "s": [None if i % 11 == 0 else f"row{i}" for i in range(n)],
        "d": [datetime.date(2020, 1, 1) + datetime.timedelta(days=int(i))
              for i in range(n)],
    })


@pytest.fixture
def pq_path(tmp_path):
    df = _sample_df()
    p = tmp_path / "data.parquet"
    pq.write_table(pa.Table.from_pandas(df), p, row_group_size=20)
    return str(p)


def _tables_equal(a: str, b: str) -> None:
    """Two written datasets hold the same rows (files of either, read by
    pyarrow and ordered)."""
    ta, tb = (pq.read_table(p) if os.path.isfile(p) else
              pa.concat_tables([pq.read_table(os.path.join(r, f))
                                for r, _, fs in sorted(os.walk(p))
                                for f in sorted(fs) if f.endswith(
                                    ".parquet")]) for p in (a, b))
    assert ta.schema.names == tb.schema.names
    da, db = ta.to_pandas(), tb.to_pandas()
    same(da, db, sort_by=list(da.columns[:1]))


# -- split planning ---------------------------------------------------------
def test_plan_file_partitions_packs_and_splits():
    cases = [([(f"/f{i}", 100 * 2 ** 20) for i in range(4)], 128 * 2 ** 20),
             ([("/big", 300 * 2 ** 20)], 128 * 2 ** 20)]
    for files, max_bytes in cases:
        outs = []
        for m in BOTH:
            parts = m.S.plan_file_partitions(
                [m.S.FileSplit(p, 0, n, n) for p, n in files], max_bytes,
                4 * 2 ** 20)
            outs.append([[(s.path, s.start, s.length) for s in p.splits]
                         for p in parts])
        assert outs[0] == outs[1]
    parts = S.plan_file_partitions(
        [S.FileSplit(f"/f{i}", 0, 100 * 2 ** 20, 100 * 2 ** 20)
         for i in range(4)], 128 * 2 ** 20, 4 * 2 ** 20)
    assert sum(s.length for p in parts for s in p.splits) == 4 * 100 * 2**20
    for p in parts:
        assert sum(s.length + 4 * 2 ** 20 for s in p.splits) <= 128 * 2**20
    big = S.plan_file_partitions(
        [S.FileSplit("/big", 0, 300 * 2 ** 20, 300 * 2 ** 20)],
        128 * 2 ** 20, 4 * 2 ** 20)
    assert len(big) >= 3
    end = 0
    for start, length in sorted((s.start, s.length) for p in big
                                for s in p.splits):
        assert start == end
        end = start + length
    assert end == 300 * 2 ** 20


def test_discover_hive_partitions(tmp_path):
    for year, n in ((2020, 3), (2021, 4)):
        d = tmp_path / f"year={year}"
        d.mkdir()
        pq.write_table(pa.Table.from_pandas(
            pd.DataFrame({"x": np.arange(n, dtype=np.int64)})),
            d / "part-0.parquet")
    (rfiles, rschema), (files, schema) = (
        m.S.discover_files(str(tmp_path), ".parquet") for m in BOTH)
    assert [(f.path, f.length, f.partition_values) for f in files] == \
        [(f.path, f.length, f.partition_values) for f in rfiles]
    assert schema.names == rschema.names == ("year",)
    assert schema.field("year").dtype == T.INT64
    assert dict(files[0].partition_values)["year"] == 2020


# -- pushdown ---------------------------------------------------------------
def _might(m, build, stats):
    return m.PD.might_match(build(m), {
        k: m.PD.ColumnStats(**v) for k, v in stats.items()})


@pytest.mark.parametrize("case,want", [
    (lambda m: m.col("a") > 25, False),
    (lambda m: m.col("a") > 15, True),
    (lambda m: m.col("a") < 10, False),
    (lambda m: m.col("a") <= 10, True),
    (lambda m: m.P.EqualTo(m.col("a"), m.lit(5)), False),
    (lambda m: m.lit(25) > m.col("a"), True),
    (lambda m: m.lit(5) > m.col("a"), False),
    (lambda m: (m.col("a") > 25) & (m.col("a") < 30), False),
    (lambda m: (m.col("a") > 25) | (m.col("a") < 12), True)])
def test_pushdown_range_pruning(case, want):
    stats = {"a": dict(min=10, max=20, null_count=0, num_values=100)}
    assert _might(REF, case, stats) is _might(PORT, case, stats) is want


def test_pushdown_nulls_and_unknown():
    stats = {"a": dict(min=1, max=2, null_count=100, num_values=100)}
    for case, want in (
            (lambda m: m.P.IsNotNull(m.col("a")), False),
            (lambda m: m.P.IsNull(m.col("a")), True),
            (lambda m: m.col("a") > 0, False),  # all null
            (lambda m: m.col("zz") > 0, True)):  # unknown column stays
        assert _might(REF, case, stats) is _might(PORT, case, stats) is want


# -- parquet ----------------------------------------------------------------
def test_parquet_scan_parity(pq_path):
    plan = both_same(lambda m: m.io.read_parquet(pq_path))
    assert isinstance(plan, X.TpuFileSourceScanExec)


def test_parquet_filter_pushdown_prunes_row_groups(pq_path):
    rows = []
    for m in BOTH:
        c = conf(m)
        scan = m.X.ScanDescription(pq_path, "parquet", conf=c)
        kw = {"device": "cpu"} if m is PORT else {}
        ex = m.X.TpuFileSourceScanExec(
            scan, pushed_filter=(m.col("i") >= 90), conf=c, **kw)
        rows.append([int(v) for b in ex.execute_columnar()
                     for v in b.column("i").to_numpy(b.num_rows)[0]])
    # only the last row group (rows 80..99) survives the stats filter
    assert rows[0] == rows[1] == list(range(80, 100))
    assert (scan.reader.counts.read, scan.reader.counts.total) == (1, 5)


def test_parquet_legacy_rebase_falls_back(pq_path):
    key = "spark.sql.legacy.parquet.datetimeRebaseModeInRead"
    for m in BOTH:
        out = accel(m, m.io.read_parquet(pq_path), conf(m, **{key: "LEGACY"}))
        assert isinstance(out, m.N.CpuNode)
        c300 = conf(m, **{"spark.rapids.tpu.sparkVersion": "3.0.0",
                          "spark.sql.legacy.parquet.rebaseDateTimeInRead":
                          "true"})
        assert isinstance(accel(m, m.io.read_parquet(pq_path), c300),
                          m.N.CpuNode)
    out = accel(PORT, pio.read_parquet(pq_path),
                conf(PORT, **{key: "LEGACY"}))
    O.ExecutionPlanCapture.assert_did_fall_back("CpuFileScan[parquet]")
    del out


def _find_scans(plan):
    out = [plan] if isinstance(plan, X.TpuFileSourceScanExec) else []
    for c in getattr(plan, "children", []):
        out.extend(_find_scans(c))
    return out


def test_parquet_filter_query_parity(pq_path):
    plan = both_same(lambda m: m.N.CpuFilter(
        (m.col("i") >= m.lit(25)) & (m.col("i") < m.lit(35)),
        m.io.read_parquet(pq_path)))
    scans = _find_scans(plan)
    assert scans and scans[0].pushed_filter is not None
    assert O.ExecutionPlanCapture.last_plan is plan


def test_parquet_partitioned_dataset(tmp_path):
    for year in (2020, 2021):
        d = tmp_path / f"year={year}"
        d.mkdir()
        pq.write_table(pa.Table.from_pandas(pd.DataFrame({
            "x": np.arange(5, dtype=np.int64) + year})), d / "p.parquet")
    assert pio.read_parquet(str(tmp_path)).output_schema().names == \
        ("x", "year")
    both_same(lambda m: m.io.read_parquet(str(tmp_path)),
              sort_by=["year", "x"])


def test_parquet_schema_evolution(tmp_path):
    # the file lacks column "extra"; the read schema requests it -> nulls
    pq.write_table(pa.Table.from_pandas(
        pd.DataFrame({"x": np.arange(4, dtype=np.int64)})),
        tmp_path / "f.parquet")
    outs = [run(m, m.io.read_parquet(
        str(tmp_path / "f.parquet"),
        m.T.Schema.of(("x", m.T.INT64), ("extra", m.T.FLOAT64))))[0]
        for m in BOTH]
    same(*outs)
    assert outs[1]["extra"].isna().all()
    assert list(outs[1]["x"]) == [0, 1, 2, 3]


def test_parquet_fallback_when_disabled(pq_path):
    for m in BOTH:
        c = conf(m).set(m.C.PARQUET_ENABLED.key, False)
        plan = accel(m, m.io.read_parquet(pq_path), c)
        assert isinstance(plan, m.N.CpuNode)  # the scan stayed on the CPU
        got = (RO if m is REF else O).collect(plan, c)
        assert len(got) == 100
    assert not isinstance(plan, TpuExec)


# -- orc --------------------------------------------------------------------
def test_orc_scan_parity(tmp_path):
    from pyarrow import orc
    p = tmp_path / "data.orc"
    orc.write_table(pa.Table.from_pandas(_sample_df(60)), str(p))
    both_same(lambda m: m.io.read_orc(str(p)))


# -- csv --------------------------------------------------------------------
def test_csv_scan_parity(tmp_path):
    p = tmp_path / "data.csv"
    with open(p, "w") as f:
        f.write("i,f,s\n")
        for i in range(50):
            s = "" if i % 7 == 0 else f"v{i}"
            f.write(f"{i},{i * 0.5},{s}\n")
    plan = both_same(lambda m: m.io.read_csv(str(p), m.T.Schema.of(
        ("i", m.T.INT64), ("f", m.T.FLOAT64), ("s", m.T.STRING)),
        m.CsvOptions(header=True)))
    assert isinstance(plan, X.TpuFileSourceScanExec)


def test_csv_unsupported_options_fall_back(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("a;b\n1;2\n")
    for m in BOTH:
        scan = m.io.read_csv(str(p), m.T.Schema.of(
            ("a", m.T.INT64), ("b", m.T.INT64)), m.CsvOptions(sep=";;"))
        assert isinstance(accel(m, scan), m.N.CpuNode)


def test_csv_split_line_boundaries(tmp_path):
    # many splits over one file: rows must not be lost or duplicated
    p = tmp_path / "big.csv"
    with open(p, "w") as f:
        for i in range(2000):
            f.write(f"{i},{'x' * (i % 37)}\n")
    got = []
    for m in BOTH:
        schema = m.T.Schema.of(("i", m.T.INT64), ("s", m.T.STRING))
        c = conf(m).set(m.C.MAX_PARTITION_BYTES.key, 4096).set(
            m.C.FILE_OPEN_COST.key, 0)
        m.C.set_active_conf(c)
        try:
            scan = m.X.ScanDescription(str(p), "csv", schema,
                                       m.CsvOptions(), conf=c)
            assert len(scan.partitions) > 1
            kw = {"device": "cpu"} if m is PORT else {}
            ex = m.X.TpuFileSourceScanExec(scan, conf=c, **kw)
            got.append([(int(i), s) for b in ex.execute_columnar()
                        for i, s in zip(b.column("i").to_numpy(
                            b.num_rows)[0], b.column("s").to_numpy(
                            b.num_rows)[0])])
        finally:
            m.C.set_active_conf(m.C.RapidsConf())
    assert got[0] == got[1]
    assert sorted(i for i, _ in got[1]) == list(range(2000))


# -- write path -------------------------------------------------------------
def test_parquet_write_roundtrip(tmp_path):
    df = _sample_df(40)
    outs = []
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        stats = m.W.write_batches(iter([b]), out, "parquet", b.schema)
        assert stats.num_files == 1 and stats.num_rows == 40
        assert os.path.exists(os.path.join(out, "_SUCCESS"))
        outs.append(out)
    _tables_equal(*outs)
    backs = [run(m, m.io.read_parquet(o))[0] for m, o in zip(BOTH, outs)]
    same(*backs)
    assert list(backs[1]["i"]) == list(range(40))


def test_write_exec_plan_parity(tmp_path):
    df = _sample_df(30)
    outs = []
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        res, plan = run(m, m.io.write(
            m.N.CpuSource.from_pandas(df, num_partitions=2), out, "parquet"))
        assert type(plan).__name__ == "TpuWriteFilesExec"
        assert int(res["num_rows"][0]) == 30
        outs.append(out)
    _tables_equal(*outs)
    back = run(PORT, pio.read_parquet(outs[1]))[0]
    assert sorted(back["i"]) == list(range(30))


def test_dynamic_partition_write(tmp_path):
    df = pd.DataFrame({
        "k": ["a", "b", "a", None, "b", "a"],
        "v": np.arange(6, dtype=np.int64)})
    outs = []
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        stats = m.W.write_batches(iter([b]), out, "parquet", b.schema,
                                  partition_by=["k"])
        for part in ("k=a", "k=b", "k=__HIVE_DEFAULT_PARTITION__"):
            assert os.path.isdir(os.path.join(out, part))
        assert stats.num_rows == 6 and stats.num_files == 3
        outs.append(out)
    backs = [run(m, m.io.read_parquet(o))[0] for m, o in zip(BOTH, outs)]
    same(*backs, sort_by=["v"])
    assert sorted(backs[1]["v"]) == list(range(6))


def test_orc_write_roundtrip(tmp_path):
    df = _sample_df(25)
    backs = []
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        stats = m.W.write_batches(iter([b]), out, "orc", b.schema)
        assert stats.num_rows == 25
        backs.append(run(m, m.io.read_orc(out))[0])
    same(*backs)
    assert len(backs[1]) == 25


def test_write_mode_error_and_overwrite(tmp_path):
    df = pd.DataFrame({"x": np.arange(3, dtype=np.int64)})
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        m.W.write_batches(iter([b]), out, "parquet", b.schema)
        with pytest.raises(FileExistsError):
            m.W.write_batches(iter([b]), out, "parquet", b.schema)
        m.W.write_batches(iter([b]), out, "parquet", b.schema,
                          mode="overwrite")
        assert len(run(m, m.io.read_parquet(out))[0]) == 3


def test_csv_partitioned_dataset(tmp_path):
    # the partition column is in the user schema but not in the files
    for year in (2020, 2021):
        d = tmp_path / f"year={year}"
        d.mkdir()
        with open(d / "p.csv", "w") as f:
            for i in range(4):
                f.write(f"{i},{year}-v{i}\n")

    def build(m):
        return m.io.read_csv(str(tmp_path), m.T.Schema.of(
            ("i", m.T.INT64), ("s", m.T.STRING), ("year", m.T.INT64)),
            m.CsvOptions())
    assert build(PORT).output_schema().names == ("i", "s", "year")
    outs = [run(m, build(m))[0] for m in BOTH]
    same(*outs, sort_by=["s"])
    assert len(outs[1]) == 8
    assert sorted(outs[1]["year"].unique()) == [2020, 2021]


def test_write_unsupported_format_does_not_destroy_output(tmp_path):
    df = pd.DataFrame({"x": np.arange(3, dtype=np.int64)})
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        m.W.write_batches(iter([b]), out, "parquet", b.schema)
        with pytest.raises(ValueError, match="unsupported write format"):
            m.W.write_batches(iter([b]), out, "csv", b.schema,
                              mode="overwrite")
        # the existing parquet output survived the failed overwrite
        assert len(run(m, m.io.read_parquet(out))[0]) == 3


# --- hybrid-calendar rebase ----------------------------------------------
def _legacy_day(y, m, d):
    """The day number a Spark 2.x (hybrid-calendar) writer stores for a
    pre-cutover date label."""
    return int(RRB._jdn_from_ymd(np.int64(y), np.int64(m), np.int64(d),
                                 julian=True) - RRB._EPOCH_JDN)


def test_legacy_day_agrees():
    assert _legacy_day(1200, 1, 1) == int(RB._jdn_from_ymd(
        np.int64(1200), np.int64(1), np.int64(1), julian=True)
        - RB._EPOCH_JDN)


def _write_legacy_file(path):
    stored = _legacy_day(1200, 1, 1)
    pq.write_table(pa.table({
        "d": pa.array([stored, -100, None], pa.int32()).cast(pa.date32()),
        "x": pa.array([1, 2, 3], pa.int64())}), str(path))
    return stored


def test_parquet_rebase_exception_read_raises(tmp_path):
    """EXCEPTION read mode raises Spark 3.0's upgrade error on legacy
    files holding pre-1582 dates."""
    _write_legacy_file(tmp_path / "t.parquet")
    for m in BOTH:
        plan = accel(m, m.io.read_parquet(str(tmp_path)))
        with pytest.raises(m.RB.SparkUpgradeError, match="1582-10-15"):
            (RO if m is REF else O).collect(plan)


def test_parquet_rebase_corrected_reads_verbatim(tmp_path):
    stored = _write_legacy_file(tmp_path / "t.parquet")
    key = "spark.sql.legacy.parquet.datetimeRebaseModeInRead"
    outs = [run(m, m.io.read_parquet(str(tmp_path)),
                conf(m, **{key: "CORRECTED"}))[0] for m in BOTH]
    same(*outs)
    assert int(outs[1]["d"].iloc[0]) == stored


def test_parquet_rebase_legacy_cpu_engine_rebases(tmp_path):
    """LEGACY falls back to the CPU engine, which rebases Julian to
    Gregorian: the pre-cutover *label* is kept."""
    _write_legacy_file(tmp_path / "t.parquet")
    key = "spark.sql.legacy.parquet.datetimeRebaseModeInRead"
    outs = []
    for m in BOTH:
        c = conf(m, **{key: "LEGACY"})
        plan = accel(m, m.io.read_parquet(str(tmp_path)), c)
        assert isinstance(plan, m.N.CpuNode)
        outs.append((RO if m is REF else O).collect(plan, c))
    same(*outs)
    want = (datetime.date(1200, 1, 1) - datetime.date(1970, 1, 1)).days
    assert int(outs[1]["d"].iloc[0]) == want
    assert int(outs[1]["d"].iloc[1]) == -100  # post-cutover rows untouched


def test_parquet_rebase_unknown_mode_falls_back(tmp_path):
    _write_legacy_file(tmp_path / "t.parquet")
    key = "spark.sql.legacy.parquet.datetimeRebaseModeInRead"
    for m in BOTH:
        assert isinstance(accel(m, m.io.read_parquet(str(tmp_path)),
                                conf(m, **{key: "BOGUS"})), m.N.CpuNode)


def test_parquet_rebase_write_exception_and_legacy(tmp_path):
    gre_day = (datetime.date(1200, 1, 1) - datetime.date(1970, 1, 1)).days
    for m in BOTH:
        tag = "ref" if m is REF else "port"
        schema = m.T.Schema.of(("d", m.T.DATE32), ("x", m.T.INT64))
        batch = batch_np(m, {"d": np.array([gre_day, 0], np.int32),
                             "x": np.array([7, 8], np.int64)}, schema)
        # EXCEPTION (Spark's default) raises on pre-cutover values
        w = m.PW(str(tmp_path / f"e{tag}.parquet"), schema,
                 m.PWO(rebase_mode="EXCEPTION"))
        with pytest.raises(m.RB.SparkUpgradeError, match="1582-10-15"):
            w.write_batch(batch)
        # LEGACY writes the Julian encoding and the legacyDateTime
        # marker, and a LEGACY read gives back the original labels
        p = str(tmp_path / f"l{tag}.parquet")
        w2 = m.PW(p, schema, m.PWO(rebase_mode="LEGACY"))
        w2.write_batch(batch)
        w2.close()
        assert m.RB.SPARK_LEGACY_DATETIME_KEY in \
            pq.ParquetFile(p).metadata.metadata
        assert pq.read_table(p).column("d").cast(pa.int32()).to_pylist() \
            == [_legacy_day(1200, 1, 1), 0]
        t = m.PF("LEGACY").read_split(
            m.S.FileSplit(p, 0, os.path.getsize(p), os.path.getsize(p)),
            schema, None)
        assert t.column("d").cast(pa.int32()).to_pylist() == [gre_day, 0]


def test_parquet_rebase_corrected_files_skip_checks(tmp_path):
    """Files stamped with a Spark >= 3.0.0 version and no legacy marker
    are proleptic already: EXCEPTION mode reads them."""
    gre_day = (datetime.date(1200, 1, 1) - datetime.date(1970, 1, 1)).days
    for m in BOTH:
        schema = m.T.Schema.of(("d", m.T.DATE32), ("x", m.T.INT64))
        batch = batch_np(m, {"d": np.array([gre_day, 0], np.int32),
                             "x": np.array([7, 8], np.int64)}, schema)
        p = str(tmp_path / f"c{'ref' if m is REF else 'port'}.parquet")
        w = m.PW(p, schema, m.PWO(rebase_mode="CORRECTED"))
        w.write_batch(batch)
        w.close()
        t = m.PF("EXCEPTION").read_split(
            m.S.FileSplit(p, 0, os.path.getsize(p), os.path.getsize(p)),
            schema, None)
        assert t.column("d").cast(pa.int32()).to_pylist() == [gre_day, 0]


def test_rebase_timestamp_micros_roundtrip():
    rng = np.random.default_rng(3)
    micros = rng.integers(-130_000_000_000, -119_000_000_000,
                          200).astype(np.int64) * 1_000_000
    leg = RB.rebase_gregorian_to_julian_micros(micros)
    np.testing.assert_array_equal(
        leg, RRB.rebase_gregorian_to_julian_micros(micros))
    back = RB.rebase_julian_to_gregorian_micros(leg)
    np.testing.assert_array_equal(back, micros)
    # the time of day survives the rebase
    assert ((leg % 86400000000) == (micros % 86400000000)).all()


def test_parquet_rebase_default_is_shim_versioned(tmp_path):
    """Spark 3.0.0's boolean-era rebase keys default to false (read
    verbatim = CORRECTED); 3.0.1+ mode keys default to EXCEPTION."""
    stored = _write_legacy_file(tmp_path / "t.parquet")
    outs = [run(m, m.io.read_parquet(str(tmp_path)), conf(
        m, **{"spark.rapids.tpu.sparkVersion": "3.0.0"}))[0] for m in BOTH]
    same(*outs)
    assert int(outs[1]["d"].iloc[0]) == stored  # verbatim, no raise


def test_exception_mode_accepts_1582_to_1900_timestamps():
    """A UTC session has no Julian drift after 1582-10-15: an 1850
    timestamp is unambiguous, a 1500 one is not."""
    micros_1850 = -3786825600000000  # 1850-01-01T00:00:00Z
    micros_1500 = -14830986000000000  # ~1500 CE, pre-cutover
    for m in BOTH:
        assert not m.RB.arrow_table_needs_rebase(pa.table(
            {"t": pa.array([micros_1850], pa.timestamp("us"))}))
        assert m.RB.arrow_table_needs_rebase(pa.table(
            {"t": pa.array([micros_1500], pa.timestamp("us"))}))


# -- task-commit protocol ---------------------------------------------------
def test_write_abort_mid_task_leaves_no_partial_files(tmp_path):
    """A task that dies mid-write leaves NO files in the output: its
    attempt directory is private and abort removes it."""
    df = _sample_df(20)
    outs = []
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        job = m.W.WriteJob(out, "parquet", b.schema)
        job.setup()
        w0 = job.task_writer(0)
        w0.write(b)
        stats0 = w0.commit()          # task 0 commits
        w1 = job.task_writer(1)
        w1.write(b)                   # task 1 dies before its commit
        w1.abort()
        assert job.commit([stats0]).num_rows == 20
        files = [n for n in os.listdir(out) if n.endswith(".parquet")]
        assert len(files) == 1 and files[0].startswith("part-00000-")
        assert not os.path.exists(os.path.join(out, "_temporary"))
        outs.append(out)
    _tables_equal(*outs)


def test_write_speculative_duplicate_task_commits_once(tmp_path):
    """Two attempts of the SAME task: exactly one commit wins; the
    loser's files and stats are discarded."""
    df = _sample_df(10)
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b = batch_of(m, df)
        job = m.W.WriteJob(out, "parquet", b.schema)
        job.setup()
        a1, a2 = job.task_writer(0), job.task_writer(0)
        a1.write(b)
        a2.write(b)
        s1, s2 = a1.commit(), a2.commit()  # a2 loses the rename race
        assert s1.num_rows == 10 and s2.num_rows == 0
        assert job.commit([s1, s2]).num_rows == 10
        assert len([n for n in os.listdir(out)
                    if n.endswith(".parquet")]) == 1


def test_dynamic_partition_overwrite(tmp_path):
    """mode=dynamic_overwrite replaces ONLY the partitions present in the
    new data."""
    df1 = pd.DataFrame({"k": ["a", "b"], "v": np.array([1, 2], np.int64)})
    df2 = pd.DataFrame({"k": ["a", "a"], "v": np.array([7, 8], np.int64)})
    for m in BOTH:
        out = str(tmp_path / ("ref" if m is REF else "port"))
        b1, b2 = batch_of(m, df1), batch_of(m, df2)
        m.W.write_batches(iter([b1]), out, "parquet", b1.schema,
                          partition_by=["k"])
        m.W.write_batches(iter([b2]), out, "parquet", b2.schema,
                          partition_by=["k"], mode="dynamic_overwrite")
        back = run(m, m.io.read_parquet(out))[0]
        assert {(r["k"], int(r["v"])) for _, r in back.iterrows()} == \
            {("a", 7), ("a", 8), ("b", 2)}


def test_dynamic_overwrite_requires_partitioning(tmp_path):
    for m in BOTH:
        b = batch_of(m, _sample_df(5))
        with pytest.raises(ValueError):
            m.W.WriteJob(str(tmp_path / "x"), "parquet", b.schema,
                         mode="dynamic_overwrite")


# -- the Arrow round trip (tests/test_columnar.py) --------------------------
def test_batch_from_arrow_roundtrip():
    t = pa.table({
        "i": pa.array([1, None, 3], pa.int32()),
        "f": pa.array([1.0, 2.0, None], pa.float64()),
        "s": pa.array(["a", None, "c"]),
        "e": pa.array(["", "xyz", None]),
        "d": pa.array([datetime.date(1200, 1, 1), None,
                       datetime.date(2020, 2, 29)]),
    })
    ref = RBatch.from_arrow(t)
    batch = ColumnarBatch.from_arrow(t, device="cpu")
    assert batch.num_rows == ref.num_rows == 3
    for name in t.column_names:
        vals, valid = batch.column(name).to_numpy(3)
        rvals, rvalid = ref.column(name).to_numpy(3)
        np.testing.assert_array_equal(valid, rvalid)
        assert [v for v, ok in zip(vals.tolist(), valid) if ok] == \
            [v for v, ok in zip(np.asarray(rvals).tolist(), rvalid) if ok]
    assert batch.column("i").to_numpy(3)[1].tolist() == [True, False, True]
    t2, rt2 = batch.to_arrow(), ref.to_arrow()
    assert t2.equals(rt2)
    assert t2.column("i").to_pylist() == [1, None, 3]
    assert t2.column("e").to_pylist() == ["", "xyz", None]
