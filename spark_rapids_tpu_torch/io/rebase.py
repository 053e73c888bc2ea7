"""Hybrid-calendar (Julian <-> proleptic Gregorian) rebase detection
(port of spark_rapids_tpu/io/rebase.py; numpy and pyarrow on the host).

Spark 2.x and legacy Hive wrote dates and timestamps in the hybrid
Julian+Gregorian calendar; Spark 3.x uses the proleptic Gregorian
calendar.  Values at or after the Gregorian cutover (1582-10-15; in
non-UTC zones timestamp drift persists until 1900, but this engine is
UTC-only so the timestamp cutover is 1582-10-15 too) mean the same
instant in both calendars, so only values BEFORE the cutover are
ambiguous.  The accelerator never rebases: files and values that would
need it either raise Spark 3.0's upgrade error (EXCEPTION) or are read
verbatim (CORRECTED); LEGACY runs on the CPU engine, which rebases.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# Days since unix epoch of 1582-10-15, the first proleptic-Gregorian day
# shared by both calendars (RebaseDateTime.lastSwitchJulianDay).
CUTOVER_DAY = -141427
# Timestamp ambiguity cutover for a UTC session: UTC has no pre-1900
# timezone-offset drift, so the switch instant is exactly the date
# cutover (RebaseDateTime.lastSwitchJulianTs for UTC).  The engine is
# UTC-only (same as the reference, GpuOverrides.scala:397-409); Spark's
# 1900-01-01 wording in the upgrade-error text covers non-UTC zones and
# stays in the messages only.
CUTOVER_MICROS = CUTOVER_DAY * 86400000000

# Spark's parquet footer key-value metadata keys
# (GpuParquetScan.scala:195-197).
SPARK_VERSION_METADATA_KEY = b"org.apache.spark.version"
SPARK_LEGACY_DATETIME_KEY = b"org.apache.spark.legacyDateTime"

READ_MODES = ("EXCEPTION", "CORRECTED", "LEGACY")


def _verify_utc_session() -> None:
    """CUTOVER_MICROS equals the date cutover ONLY for a UTC session
    (non-UTC zones drift pre-1900).  The engine is UTC-only (reference
    GpuOverrides.scala:397-409 tags timestamps off outside UTC); this
    guard keeps the constant from silently going stale if a session
    timezone conf is ever introduced."""
    from spark_rapids_tpu_torch import config as C
    tz = C.get_active_conf().get("spark.sql.session.timeZone", "UTC")
    if tz not in ("UTC", "Etc/UTC", "GMT", "+00:00", "Z"):
        raise AssertionError(
            f"legacy-timestamp rebase detection requires a UTC session; "
            f"got spark.sql.session.timeZone={tz!r}")


class SparkUpgradeError(RuntimeError):
    """Analog of Spark's SparkUpgradeException (SPARK-31404)."""


def normalize_mode(raw) -> str:
    """Map a conf value to a rebase mode: Spark 3.0.0's boolean-era keys
    use true/false, 3.0.1+ use mode names (shim layer picks the key)."""
    s = str(raw).upper()
    if s == "TRUE":
        return "LEGACY"
    if s == "FALSE":
        return "CORRECTED"
    return s


def new_rebase_exception_read(fmt: str = "Parquet") -> SparkUpgradeError:
    """Reference `RebaseHelper.newRebaseExceptionInRead`."""
    return SparkUpgradeError(
        f"You may get a different result due to the upgrading of Spark"
        f" 3.0: reading dates before 1582-10-15 or timestamps before"
        f" 1900-01-01T00:00:00Z from {fmt} files can be ambiguous, as the"
        f" files may be written by a legacy hybrid calendar. The"
        f" accelerator does not support reading these 'LEGACY' files;"
        f" set the datetime rebase mode to 'CORRECTED' to read the"
        f" values as-is (SPARK-31404).")


def new_rebase_exception_write(fmt: str = "Parquet") -> SparkUpgradeError:
    """Reference `DataSourceUtils.newRebaseExceptionInWrite` path used by
    `GpuParquetFileFormat.scala:224`."""
    return SparkUpgradeError(
        f"You may get a different result due to the upgrading of Spark"
        f" 3.0: writing dates before 1582-10-15 or timestamps before"
        f" 1900-01-01T00:00:00Z into {fmt} files can be dangerous, as the"
        f" files may be read by legacy systems that use the hybrid"
        f" calendar. Set the datetime rebase mode to 'CORRECTED' to"
        f" write the values as-is (SPARK-31404).")


def is_corrected_file(kv_meta: Optional[dict],
                      corrected_mode_conf: bool) -> bool:
    """Per-file resolution (reference `isCorrectedRebaseMode`
    `GpuParquetScan.scala:199-210`): files written by Spark >= 3.0.0
    WITHOUT the legacyDateTime marker are already proleptic Gregorian;
    files with no Spark version marker inherit the session mode."""
    if kv_meta:
        version = kv_meta.get(SPARK_VERSION_METADATA_KEY)
        if version is not None:
            if isinstance(version, bytes):
                version = version.decode("utf-8", "replace")
            return (_version_at_least(version, (3, 0, 0))
                    and kv_meta.get(SPARK_LEGACY_DATETIME_KEY) is None)
    return corrected_mode_conf


def _version_at_least(version: str, floor: tuple) -> bool:
    """Numeric component-wise compare ("10.0.0" > "3.0.0"; suffixes like
    "-SNAPSHOT" ignored)."""
    parts = []
    for tok in version.split(".")[:3]:
        digits = ""
        for ch in tok:
            if not ch.isdigit():
                break
            digits += ch
        if not digits:
            return False
        parts.append(int(digits))
    return tuple(parts) >= floor


def _arrow_col_needs_rebase(col) -> bool:
    _verify_utc_session()
    import pyarrow as pa
    import pyarrow.compute as pc
    t = col.type
    if pa.types.is_date32(t):
        lo, cut = pc.min(col.cast(pa.int32())).as_py(), CUTOVER_DAY
    elif pa.types.is_timestamp(t):
        lo, cut = pc.min(col.cast(pa.timestamp("us")).cast(
            pa.int64())).as_py(), CUTOVER_MICROS
    else:
        return False
    return lo is not None and lo < cut


def arrow_table_needs_rebase(table) -> bool:
    """Read-side value check (reference
    `RebaseHelper.isDateTimeRebaseNeededRead`): any date/timestamp value
    before the cutover."""
    return any(_arrow_col_needs_rebase(table.column(i))
               for i in range(table.num_columns))


def apply_read_rebase(table, kv_meta: Optional[dict], mode: str,
                      fmt: str = "Parquet"):
    """The whole read-side decision (reference
    `GpuParquetScan.scala:247-249` + RebaseHelper): CORRECTED reads
    verbatim; files already in the proleptic calendar skip checks; LEGACY
    (CPU fallback engine only — the planner keeps LEGACY scans off the
    accelerator) performs the Julian->Gregorian rebase; EXCEPTION raises
    when pre-cutover values are present.  Returns the (possibly rebased)
    table."""
    mode = normalize_mode(mode)
    if mode not in READ_MODES:
        raise ValueError(f"{mode} is not a supported datetime rebase "
                         "mode (EXCEPTION, CORRECTED, LEGACY)")
    if mode == "CORRECTED":
        return table
    if is_corrected_file(kv_meta, corrected_mode_conf=False):
        return table
    if mode == "LEGACY":
        return rebase_arrow_table_read(table)
    if arrow_table_needs_rebase(table):
        raise new_rebase_exception_read(fmt)
    return table


def batch_needs_rebase(batch) -> bool:
    """Write-side value check over a device ColumnarBatch (Spark's
    RebaseHelper.isDateTimeRebaseNeededWrite)."""
    _verify_utc_session()
    from spark_rapids_tpu_torch import types as T
    n = batch.num_rows
    for name in batch.schema.names:
        vec = batch.column(name)
        if vec.dtype.id not in (T.TypeId.DATE32, T.TypeId.TIMESTAMP_US):
            continue
        vals, valid = vec.to_numpy(n)
        if not valid.any():
            continue
        lo = int(vals[valid].min())
        cut = (CUTOVER_DAY if vec.dtype.id == T.TypeId.DATE32
               else CUTOVER_MICROS)
        if lo < cut:
            return True
    return False


def check_batch_write(batch, mode: str, fmt: str = "Parquet") -> None:
    """EXCEPTION write mode raises on pre-cutover values
    (`GpuParquetFileFormat.scala:221-228`); CORRECTED writes verbatim;
    LEGACY never reaches the accelerator (tagged off at planning,
    `GpuParquetFileFormat.scala:83`)."""
    if normalize_mode(mode) != "EXCEPTION":
        return
    if batch_needs_rebase(batch):
        raise new_rebase_exception_write(fmt)


# ---------------------------------------------------------------------------
# Actual calendar rebasing, used by the CPU fallback engine under LEGACY
# mode (the role Spark's RebaseDateTime plays for CPU Spark; the
# accelerator itself never rebases, matching the reference).  All math is
# vectorized int64 Julian-Day-Number arithmetic; UTC sessions only (the
# engine is UTC-only like the reference, GpuOverrides.scala:397-409), so
# timestamp rebase reduces to the calendar-day shift.

_EPOCH_JDN = 2440588  # JDN of 1970-01-01 (proleptic Gregorian)
_MICROS_PER_DAY = 86400000000


def _jdn_from_ymd(y, m, d, julian: bool):
    a = (14 - m) // 12
    yy = y + 4800 - a
    mm = m + 12 * a - 3
    jdn = d + (153 * mm + 2) // 5 + 365 * yy + yy // 4
    if julian:
        return jdn - 32083
    return jdn - yy // 100 + yy // 400 - 32045


def _ymd_from_jdn(jdn, julian: bool):
    f = jdn + 1401
    if not julian:
        f = f + (((4 * jdn + 274277) // 146097) * 3) // 4 - 38
    e = 4 * f + 3
    g = (e % 1461) // 4
    h = 5 * g + 2
    d = (h % 153) // 5 + 1
    m = (h // 153 + 2) % 12 + 1
    y = e // 1461 - 4716 + (14 - m) // 12
    return y, m, d


def _rebase_days(days: np.ndarray, to_julian: bool) -> np.ndarray:
    """Re-label pre-cutover epoch days between calendars: decompose the
    day number into (y, m, d) under the source calendar, re-encode the
    same label under the target calendar."""
    days = np.asarray(days, np.int64)
    old = days < CUTOVER_DAY
    if not old.any():
        return days
    jdn = days + _EPOCH_JDN
    y, m, d = _ymd_from_jdn(jdn, julian=not to_julian)
    out = _jdn_from_ymd(y, m, d, julian=to_julian) - _EPOCH_JDN
    return np.where(old, out, days)


def rebase_julian_to_gregorian_days(days: np.ndarray) -> np.ndarray:
    """Read-side LEGACY rebase (RebaseDateTime.rebaseJulianToGregorianDays)."""
    return _rebase_days(days, to_julian=False)


def rebase_gregorian_to_julian_days(days: np.ndarray) -> np.ndarray:
    """Write-side LEGACY rebase (RebaseDateTime.rebaseGregorianToJulianDays).
    Labels inside the 1582-10-05..14 cutover gap do not exist in the
    hybrid calendar; like Spark we let them land on the Julian encoding
    of the same label (which aliases days after the gap)."""
    return _rebase_days(days, to_julian=True)


def _rebase_micros(micros: np.ndarray, to_julian: bool) -> np.ndarray:
    micros = np.asarray(micros, np.int64)
    days = micros // _MICROS_PER_DAY
    shifted = _rebase_days(days, to_julian)
    return micros + (shifted - days) * _MICROS_PER_DAY


def rebase_julian_to_gregorian_micros(micros: np.ndarray) -> np.ndarray:
    return _rebase_micros(micros, to_julian=False)


def rebase_gregorian_to_julian_micros(micros: np.ndarray) -> np.ndarray:
    return _rebase_micros(micros, to_julian=True)


def _rebase_arrow_table(table, to_julian: bool):
    import pyarrow as pa
    out = table
    for i, col in enumerate(table.columns):
        t = col.type
        if pa.types.is_date32(t):
            ints = col.cast(pa.int32()).combine_chunks().to_numpy(
                zero_copy_only=False)
            mask = np.asarray(col.is_null())
            rb = _rebase_days(np.where(mask, 0, ints),
                              to_julian).astype(np.int32)
            arr = pa.array(rb, mask=mask).cast(pa.date32())
        elif pa.types.is_timestamp(t):
            ints = col.cast(pa.timestamp("us")).cast(
                pa.int64()).combine_chunks().to_numpy(zero_copy_only=False)
            mask = np.asarray(col.is_null())
            rb = _rebase_micros(np.where(mask, 0, ints), to_julian)
            arr = pa.array(rb, mask=mask).cast(pa.timestamp("us")).cast(t)
        else:
            continue
        out = out.set_column(i, table.schema.field(i).name, arr)
    return out


def rebase_arrow_table_read(table):
    """Julian->Gregorian rebase of every date/timestamp column of a
    decoded Arrow table (LEGACY read of a legacy file on the CPU
    fallback engine)."""
    return _rebase_arrow_table(table, to_julian=False)


def rebase_arrow_table_write(table):
    """Gregorian->Julian rebase before encoding (LEGACY write on the CPU
    fallback engine)."""
    return _rebase_arrow_table(table, to_julian=True)
