"""Date and timestamp expressions (port of spark_rapids_tpu/exprs/
datetime_exprs.py).  All timestamp math is UTC only, as in the
reference.

Civil-date arithmetic comes from exprs/datetime_utils.py: int64 tensor
ops, no host round-trips.
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs import datetime_utils as DT
from spark_rapids_tpu_torch.exprs.base import (BinaryExpression, Expression,
                                               Literal, UnaryExpression,
                                               true_divide)


def _as_days(c: ColumnVector) -> torch.Tensor:
    if c.dtype.id == T.TypeId.DATE32:
        return c.data
    if c.dtype.id == T.TypeId.TIMESTAMP_US:
        return DT.micros_to_date_days(c.data)
    raise TypeError(f"expected a date or timestamp, got {c.dtype}")


@dataclasses.dataclass(eq=False, repr=False)
class _DateField(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.INT32

    def do_columnar(self, c, ctx):
        days = _as_days(c)
        return ColumnVector(T.INT32, self.field(days).to(torch.int32),
                            c.validity)


class Year(_DateField):
    def field(self, days):
        y, _, _ = DT.days_to_ymd(days)
        return y


class Month(_DateField):
    def field(self, days):
        _, m, _ = DT.days_to_ymd(days)
        return m


class DayOfMonth(_DateField):
    def field(self, days):
        _, _, d = DT.days_to_ymd(days)
        return d


class DayOfWeek(_DateField):
    def field(self, days):
        return DT.day_of_week(days)


class DayOfYear(_DateField):
    def field(self, days):
        return DT.day_of_year(days)


class Quarter(_DateField):
    def field(self, days):
        return DT.quarter(days)


def _iso_week_of(days) -> torch.Tensor:
    """(day of year - ISO day of week + 10) // 7, ISO Monday = 1."""
    dow_sun1 = DT.day_of_week(days)
    iso_dow = torch.where(dow_sun1 == 1, 7, dow_sun1 - 1)
    return DT.floor_div(DT.day_of_year(days) - iso_dow + 10, 7)


class WeekOfYear(_DateField):
    """ISO-8601 week number (Spark weekofyear)."""

    def field(self, days):
        w = _iso_week_of(days)
        y, _, _ = DT.days_to_ymd(days)
        # week 0 is the previous year's last week
        prev_w = _iso_week_of(DT.ymd_to_days(
            y - 1, torch.full_like(y, 12), torch.full_like(y, 31)))
        # past the week of Dec 28 is week 1 of the next year
        max_w = _iso_week_of(DT.ymd_to_days(
            y, torch.full_like(y, 12), torch.full_like(y, 28)))
        return torch.where(w < 1, prev_w, torch.where(w > max_w, 1, w))


class LastDay(_DateField):
    def data_type(self, schema):
        return T.DATE32

    def do_columnar(self, c, ctx):
        return ColumnVector(T.DATE32, DT.last_day_of_month(_as_days(c)),
                            c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class DateAdd(BinaryExpression):
    left: Expression   # date
    right: Expression  # days to add (int)

    def data_type(self, schema):
        return T.DATE32

    def do_columnar(self, l, r, ctx):
        days = _as_days(l) + r.data.to(torch.int32)
        return ColumnVector(T.DATE32, days.to(torch.int32),
                            l.validity & r.validity)


@dataclasses.dataclass(eq=False, repr=False)
class DateSub(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.DATE32

    def do_columnar(self, l, r, ctx):
        days = _as_days(l) - r.data.to(torch.int32)
        return ColumnVector(T.DATE32, days.to(torch.int32),
                            l.validity & r.validity)


@dataclasses.dataclass(eq=False, repr=False)
class DateDiff(BinaryExpression):
    """datediff(end, start) in days."""
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.INT32

    def do_columnar(self, l, r, ctx):
        d = _as_days(l) - _as_days(r)
        return ColumnVector(T.INT32, d.to(torch.int32),
                            l.validity & r.validity)


@dataclasses.dataclass(eq=False, repr=False)
class AddMonths(BinaryExpression):
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.DATE32

    def do_columnar(self, l, r, ctx):
        y, m, d = DT.days_to_ymd(_as_days(l))
        total = (y * 12 + (m - 1)) + r.data.to(torch.int64)
        ny = DT.floor_div(total, 12)
        nm = total - ny * 12 + 1
        # the day clamps to the target month's last day (Spark, Java)
        first = DT.ymd_to_days(ny, nm, torch.ones_like(nm))
        _, _, last_d = DT.days_to_ymd(DT.last_day_of_month(first))
        out = DT.ymd_to_days(ny, nm, torch.minimum(d, last_d))
        return ColumnVector(T.DATE32, out, l.validity & r.validity)


@dataclasses.dataclass(eq=False, repr=False)
class _TimeField(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.INT32

    def do_columnar(self, c, ctx):
        if c.dtype.id != T.TypeId.TIMESTAMP_US:
            raise TypeError(f"expected a timestamp, got {c.dtype}")
        h, mnt, s, us = DT.micros_time_of_day(c.data)
        return ColumnVector(T.INT32, self.pick(h, mnt, s, us).to(
            torch.int32), c.validity)


class Hour(_TimeField):
    def pick(self, h, mnt, s, us):
        return h


class Minute(_TimeField):
    def pick(self, h, mnt, s, us):
        return mnt


class Second(_TimeField):
    def pick(self, h, mnt, s, us):
        return s


@dataclasses.dataclass(eq=False, repr=False)
class MonthsBetween(BinaryExpression):
    """months_between(end, start), Spark's semantics: whole months when
    both sides fall on the same day of the month at the same time, or
    both on the last day of their month; otherwise the months plus the
    day and time difference over 31, rounded to 8 decimals
    (roundOff=true)."""
    left: Expression
    right: Expression

    def data_type(self, schema):
        return T.FLOAT64

    @staticmethod
    def _sec_of_day(c):
        if c.dtype.id == T.TypeId.TIMESTAMP_US:
            days = DT.micros_to_date_days(c.data)
            tod = c.data - days.to(torch.int64) * DT.MICROS_PER_DAY
            return true_divide(tod.to(torch.float64), DT.MICROS_PER_SECOND)
        return torch.zeros(c.capacity, dtype=torch.float64,
                           device=c.device)

    def do_columnar(self, l, r, ctx):
        y1, m1, d1 = DT.days_to_ymd(_as_days(l))
        y2, m2, d2 = DT.days_to_ymd(_as_days(r))
        s1 = self._sec_of_day(l)
        s2 = self._sec_of_day(r)
        _, _, ld1 = DT.days_to_ymd(DT.last_day_of_month(_as_days(l)))
        _, _, ld2 = DT.days_to_ymd(DT.last_day_of_month(_as_days(r)))
        both_last = (d1 == ld1) & (d2 == ld2)
        same_point = (d1 == d2) & (s1 == s2)
        months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
        frac = true_divide((d1 - d2).to(torch.float64)
                           + true_divide(s1 - s2, 86400.0), 31.0)
        out = torch.where(both_last | same_point, months, months + frac)
        # roundOff=true, half to even
        out = true_divide(torch.round(out * 1e8), 1e8)
        return ColumnVector(T.FLOAT64, out, l.validity & r.validity)


@dataclasses.dataclass(eq=False, repr=False)
class UnixTimestamp(UnaryExpression):
    """unix_timestamp(ts): seconds since the epoch (UTC)."""
    child: Expression

    def data_type(self, schema):
        return T.INT64

    def do_columnar(self, c, ctx):
        if c.dtype.id == T.TypeId.TIMESTAMP_US:
            secs = DT.floor_div(c.data, DT.MICROS_PER_SECOND)
        elif c.dtype.id == T.TypeId.DATE32:
            secs = c.data.to(torch.int64) * 86400
        else:
            raise TypeError(
                "unix_timestamp on strings requires a format parse; only "
                "date and timestamp inputs run on the device")
        return ColumnVector(T.INT64, secs.to(torch.int64), c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class FromUnixTime(UnaryExpression):
    """from_unixtime(secs) -> timestamp (Spark gives a formatted string;
    as in the reference, cast to STRING for the text form)."""
    child: Expression

    def data_type(self, schema):
        return T.TIMESTAMP_US

    def do_columnar(self, c, ctx):
        return ColumnVector(T.TIMESTAMP_US,
                            c.data.to(torch.int64) * DT.MICROS_PER_SECOND,
                            c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class ToDate(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return T.DATE32

    def do_columnar(self, c, ctx):
        if c.dtype.id == T.TypeId.DATE32:
            return c
        if c.dtype.id == T.TypeId.TIMESTAMP_US:
            return ColumnVector(T.DATE32, DT.micros_to_date_days(c.data),
                                c.validity)
        from spark_rapids_tpu_torch.exprs.cast import _string_to_date
        return _string_to_date(c)


@dataclasses.dataclass(eq=False, repr=False)
class TruncDate(Expression):
    """trunc(date, fmt) for fmt year, month or week."""
    child: Expression
    fmt: Expression

    def data_type(self, schema):
        return T.DATE32

    def children(self):
        return (self.child, self.fmt)

    def with_children(self, kids):
        return TruncDate(*kids)

    def eval(self, ctx):
        if not isinstance(self.fmt, Literal):
            raise TypeError("trunc requires a literal format")
        c = self.child.eval(ctx)
        days = _as_days(c)
        f = str(self.fmt.value).lower()
        y, m, d = DT.days_to_ymd(days)
        if f in ("year", "yyyy", "yy"):
            out = DT.ymd_to_days(y, torch.ones_like(m), torch.ones_like(d))
        elif f in ("month", "mon", "mm"):
            out = DT.ymd_to_days(y, m, torch.ones_like(d))
        elif f == "week":
            # the Monday of the current week
            dow_sun1 = DT.day_of_week(days)
            iso = torch.where(dow_sun1 == 1, 7, dow_sun1 - 1)
            out = (days.to(torch.int64) - (iso - 1)).to(torch.int32)
        else:
            raise ValueError(f"unsupported trunc format {f!r}")
        return ColumnVector(T.DATE32, out, c.validity)

    def __repr__(self):
        return f"TruncDate({self.child!r}, {self.fmt!r})"


@dataclasses.dataclass(eq=False, repr=False)
class WeekDay(UnaryExpression):
    """weekday(date): 0 = Monday ... 6 = Sunday.  It reads the storage
    value as days, as the reference does."""
    child: Expression

    def data_type(self, schema):
        return T.INT32

    def do_columnar(self, c, ctx):
        d = c.data.to(torch.int64)
        # 1970-01-01 was a Thursday (3 counting from Monday = 0)
        return ColumnVector(T.INT32, torch.remainder(d + 3, 7).to(
            torch.int32), c.validity)


@dataclasses.dataclass(eq=False, repr=False)
class ToUnixTimestamp(UnaryExpression):
    """to_unix_timestamp(ts): UnixTimestamp's function under Spark's
    other expression name."""
    child: Expression

    def data_type(self, schema):
        return T.INT64

    def do_columnar(self, c, ctx):
        return UnixTimestamp(self.child).do_columnar(c, ctx)


@dataclasses.dataclass(eq=False, repr=False)
class TimeAdd(BinaryExpression):
    """timestamp + an interval's microseconds (month intervals are not
    taken, as in the reference)."""
    left: Expression   # timestamp
    right: Expression  # interval micros (int64)

    def data_type(self, schema):
        return T.TIMESTAMP_US

    def do_columnar(self, l, r, ctx):
        return ColumnVector(T.TIMESTAMP_US,
                            l.data.to(torch.int64) + r.data.to(torch.int64),
                            l.validity & r.validity)
