"""Date expressions on DATE32 (port of spark_rapids_tpu/exprs/
datetime_exprs.py, cut to DATE32: the port has no TIMESTAMP type, so
the time-of-day fields and the timestamp conversions wait for it).

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
                                               UnaryExpression)


def _as_days(c: ColumnVector) -> torch.Tensor:
    if c.dtype.id == T.TypeId.DATE32:
        return c.data
    raise TypeError(f"expected a date, got {c.dtype}")


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
