"""Vectorized civil-calendar arithmetic on the proleptic Gregorian
calendar (port of spark_rapids_tpu/exprs/datetime_utils.py): DATE32
is int32 days and TIMESTAMP_US int64 microseconds since the epoch.

Howard Hinnant's days<->civil algorithms in int64 tensor ops, so a date
field is a handful of elementwise kernels on the batch's own device.
Every division floors, as the algorithms require for dates before 1970
(`torch.div(..., rounding_mode="floor")`; C-style truncation would be
wrong there).
"""
from __future__ import annotations

import torch

MICROS_PER_SECOND = 1_000_000
MICROS_PER_DAY = 86_400 * MICROS_PER_SECOND


def floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def days_to_ymd(days: torch.Tensor):
    """int32 days-since-epoch -> int64 (year, month, day)."""
    z = days.to(torch.int64) + 719468
    era = floor_div(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                        # [0, 146096]
    yoe = floor_div(doe - floor_div(doe, 1460) + floor_div(doe, 36524)
                    - floor_div(doe, 146096), 365)
    y = yoe + era * 400
    # day of the year starting in March, [0, 365]
    doy = doe - (365 * yoe + floor_div(yoe, 4) - floor_div(yoe, 100))
    mp = floor_div(5 * doy + 2, 153)              # [0, 11]
    d = doy - floor_div(153 * mp + 2, 5) + 1      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)      # [1, 12]
    year = y + (m <= 2).to(torch.int64)
    return year, m, d


def ymd_to_days(y, m, d) -> torch.Tensor:
    """(year, month, day) -> int32 days-since-epoch."""
    y = y.to(torch.int64)
    m = m.to(torch.int64)
    d = d.to(torch.int64)
    y = y - (m <= 2).to(torch.int64)
    era = floor_div(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400                           # [0, 399]
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = floor_div(153 * mp + 2, 5) + d - 1      # [0, 365]
    # day of the era, [0, 146096]
    doe = yoe * 365 + floor_div(yoe, 4) - floor_div(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def day_of_week(days: torch.Tensor) -> torch.Tensor:
    """1 = Sunday ... 7 = Saturday (Spark's dayofweek); 1970-01-01 was a
    Thursday."""
    d = days.to(torch.int64)
    return torch.remainder(d + 4, 7) + 1


def day_of_year(days: torch.Tensor) -> torch.Tensor:
    y, m, d = days_to_ymd(days)
    jan1 = ymd_to_days(y, torch.ones_like(m), torch.ones_like(d))
    return (days.to(torch.int64) - jan1 + 1).to(torch.int32)


def quarter(days: torch.Tensor) -> torch.Tensor:
    _, m, _ = days_to_ymd(days)
    return (floor_div(m - 1, 3) + 1).to(torch.int32)


def last_day_of_month(days: torch.Tensor) -> torch.Tensor:
    y, m, _ = days_to_ymd(days)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    first_next = ymd_to_days(ny, nm, torch.ones_like(nm))
    return (first_next - 1).to(torch.int32)


def micros_to_date_days(micros: torch.Tensor) -> torch.Tensor:
    """Timestamp micros -> date days (floors, so instants before the
    epoch fall on the day they belong to)."""
    return floor_div(micros.to(torch.int64), MICROS_PER_DAY).to(torch.int32)


def micros_time_of_day(micros: torch.Tensor):
    """-> int64 (hour, minute, second, microsecond), all non-negative."""
    micros = micros.to(torch.int64)
    tod = micros - floor_div(micros, MICROS_PER_DAY) * MICROS_PER_DAY
    sec = floor_div(tod, MICROS_PER_SECOND)
    us = tod - sec * MICROS_PER_SECOND
    h = floor_div(sec, 3600)
    mnt = floor_div(sec - h * 3600, 60)
    s = sec - h * 3600 - mnt * 60
    return h, mnt, s, us
