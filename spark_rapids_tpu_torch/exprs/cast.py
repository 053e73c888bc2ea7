"""Cast expression (port of spark_rapids_tpu/exprs/cast.py).

Spark's non-ANSI semantics, on the device:
  - float -> integral: Java's, truncate toward zero, saturate at the
    type's bounds, NaN -> 0;
  - numeric -> bool: nonzero is true; bool -> numeric: 1 / 0;
  - integral and float widening or narrowing: wraps like Java;
  - timestamp <-> date by UTC days; timestamp <-> numeric in seconds
    (a NaN or infinite double gives a null timestamp);
  - to string: digits and formats made over byte matrices (floats in
    Java's Double.toString notation, shortest round trip);
  - from string: trimmed parses, anything invalid gives null.

ANSI mode: a float or integral cast to an integral type that overflows
raises `ArithmeticError` at the collect boundary (a deferred check on
`EvalContext.pending_checks`); the planner leaves any other ANSI pair on
the CPU.  Float -> string, string -> float and string -> timestamp are
gated by their conf keys, as in the reference (plan/overrides.py).

The int64 lanes stand in for the reference's uint64 accumulators: they
wrap the same bits, and `_ule` compares them unsigned.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import (ColumnVector,
                                                    _pad_chars)
from spark_rapids_tpu_torch.exprs import datetime_utils as DT
from spark_rapids_tpu_torch.exprs.base import (EvalContext, Expression,
                                               true_divide)
from spark_rapids_tpu_torch.exprs.string_fns import first_true

_INT_BOUNDS = {
    T.TypeId.INT8: (-(2 ** 7), 2 ** 7 - 1),
    T.TypeId.INT16: (-(2 ** 15), 2 ** 15 - 1),
    T.TypeId.INT32: (-(2 ** 31), 2 ** 31 - 1),
    T.TypeId.INT64: (-(2 ** 63), 2 ** 63 - 1),
}

_I64_MIN = -(2 ** 63)


def _bounds(dt: T.DataType):
    return _INT_BOUNDS[dt.id if dt.id in _INT_BOUNDS else T.TypeId.INT64]


def _table(values, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(dev)


@dataclasses.dataclass(eq=False)
class Cast(Expression):
    child: Expression
    to: T.DataType
    ansi: bool = False

    def data_type(self, schema):
        return self.to

    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return Cast(kids[0], self.to, self.ansi)

    def eval(self, ctx: EvalContext) -> ColumnVector:
        c = self.child.eval(ctx)
        src, dst = c.dtype, self.to
        if src == dst:
            return c
        if dst.is_string:
            return _to_string(c)
        if src.is_string:
            return _from_string(c, dst)
        if dst.id == T.TypeId.BOOL:
            return ColumnVector(T.BOOL, c.data != 0, c.validity)
        if src.id == T.TypeId.BOOL:
            return ColumnVector(dst, c.data.to(dst.torch_dtype), c.validity)
        if src.is_floating and dst.is_integral:
            if self.ansi:
                lo, hi = _bounds(dst)
                t = torch.trunc(torch.where(torch.isnan(c.data), 0.0,
                                            c.data))
                bad = ((torch.isnan(c.data) | (t < float(lo))
                        | (t > float(hi))) & c.validity & ctx.row_mask)
                ctx.pending_checks.append(
                    (f"ANSI cast {src} -> {dst} overflow", bad.any()))
            return _float_to_int(c, dst)
        if src.id == T.TypeId.TIMESTAMP_US and dst.id == T.TypeId.DATE32:
            return ColumnVector(T.DATE32, DT.micros_to_date_days(c.data),
                                c.validity)
        if src.id == T.TypeId.DATE32 and dst.id == T.TypeId.TIMESTAMP_US:
            return ColumnVector(T.TIMESTAMP_US,
                                c.data.to(torch.int64) * DT.MICROS_PER_DAY,
                                c.validity)
        if src.id == T.TypeId.TIMESTAMP_US and dst.is_numeric:
            # Spark: timestamp -> long/double is SECONDS since the epoch
            if dst.is_floating:
                secs = true_divide(c.data.to(torch.float64),
                                   DT.MICROS_PER_SECOND)
                return ColumnVector(dst, secs.to(dst.torch_dtype),
                                    c.validity)
            secs = DT.floor_div(c.data, DT.MICROS_PER_SECOND)
            return ColumnVector(dst, secs.to(dst.torch_dtype), c.validity)
        if dst.id == T.TypeId.TIMESTAMP_US and src.is_numeric:
            if src.is_floating:
                # Spark's doubleToTimestamp: NaN and Infinity give null
                bad = torch.isnan(c.data) | torch.isinf(c.data)
                safe = torch.where(bad, 0.0, c.data.to(torch.float64))
                return ColumnVector(
                    T.TIMESTAMP_US,
                    f64_to_i64(safe * DT.MICROS_PER_SECOND),
                    c.validity & ~bad)
            return ColumnVector(T.TIMESTAMP_US,
                                c.data.to(torch.int64) * DT.MICROS_PER_SECOND,
                                c.validity)
        # integral and float widening or narrowing wraps as in Java;
        # under ANSI an out-of-range value raises at the collect boundary
        if self.ansi and src.is_integral and dst.is_integral and \
                dst.id in _INT_BOUNDS:
            lo, hi = _INT_BOUNDS[dst.id]
            v = c.data.to(torch.int64)
            bad = ((v < lo) | (v > hi)) & c.validity & ctx.row_mask
            ctx.pending_checks.append(
                (f"ANSI cast {src} -> {dst} overflow", bad.any()))
        return ColumnVector(dst, c.data.to(dst.torch_dtype), c.validity)

    def __repr__(self):
        return f"cast({self.child!r} as {self.to})"


def f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 truncating, as XLA's convert does: NaN gives 0
    and a value at or past +-2^63 the bound (torch's own convert is
    undefined there)."""
    over = x >= 2.0 ** 63
    under = x < -(2.0 ** 63)
    safe = torch.where(over | under | torch.isnan(x), 0.0, x).to(torch.int64)
    return torch.where(over, 2 ** 63 - 1, torch.where(under, _I64_MIN, safe))


def _float_to_int(c: ColumnVector, dst: T.DataType) -> ColumnVector:
    """Truncate toward zero; NaN -> 0; saturate at the bounds by explicit
    selects (a float's conversion past the range is undefined)."""
    lo, hi = _bounds(dst)
    x = c.data
    trunc = torch.trunc(torch.where(torch.isnan(x), 0.0, x))
    over = trunc >= float(hi)
    under = trunc <= float(lo)
    safe = torch.where(over | under, 0.0, trunc).to(torch.int64)
    data = torch.where(over, hi, torch.where(under, lo, safe))
    return ColumnVector(dst, data.to(dst.torch_dtype), c.validity)


def _ule(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a <= b of int64 bit patterns."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    return (a ^ _I64_MIN) <= (b ^ _I64_MIN)


def _positions(n: int, dev) -> torch.Tensor:
    return torch.arange(n, device=dev)[None, :]


# --------------------------------------------------------------------------
# to string: digits and formats made on the device over byte matrices
_MAX_I64_DIGITS = 19


def _int_to_string(values: torch.Tensor):
    """int64 -> (uint8[cap, 20], int32 lengths).  The digits come from
    the value's non-positive twin, so INT64_MIN needs no special case."""
    v = values.to(torch.int64)
    neg = v < 0
    npos = torch.where(neg, v, -v)  # <= 0
    pows = _table([10 ** (18 - k) for k in range(_MAX_I64_DIGITS)],
                  torch.int64, v.device)
    q = torch.div(npos[:, None], pows[None, :], rounding_mode="trunc")
    digits = -torch.fmod(q, 10)                             # [cap, 19]
    nz = digits != 0
    ndig = torch.where(nz.any(dim=1), _MAX_I64_DIGITS - first_true(nz), 1)
    negi = neg.to(torch.int64)
    length = ndig + negi
    width = _MAX_I64_DIGITS + 1
    pos = _positions(width, v.device)
    didx = torch.clamp((_MAX_I64_DIGITS - ndig)[:, None] + pos
                       - negi[:, None], 0, _MAX_I64_DIGITS - 1)
    out = torch.gather(digits, 1, didx) + ord("0")
    out = torch.where(neg[:, None] & (pos == 0), ord("-"), out)
    out = torch.where(pos < length[:, None], out, 0).to(torch.uint8)
    return out, length.to(torch.int32)


def _pad2(x: torch.Tensor) -> torch.Tensor:
    """int -> two ASCII digits [cap, 2]."""
    x = x.to(torch.int64)
    return torch.stack([DT.floor_div(x, 10) + ord("0"),
                        torch.remainder(x, 10) + ord("0")],
                       dim=1).to(torch.uint8)


def _date_to_string(days: torch.Tensor):
    """date32 -> 'yyyy-MM-dd' (width 10; years 0000-9999)."""
    y, m, d = DT.days_to_ymd(days)
    yc = torch.stack([torch.remainder(DT.floor_div(y, p), 10)
                      for p in (1000, 100, 10, 1)], dim=1) + ord("0")
    dash = torch.full((days.shape[0], 1), ord("-"), dtype=torch.uint8,
                      device=days.device)
    out = torch.cat([yc.to(torch.uint8), dash, _pad2(m), dash, _pad2(d)],
                    dim=1)
    return out, torch.full((days.shape[0],), 10, dtype=torch.int32,
                           device=days.device)


def _timestamp_to_string(micros: torch.Tensor):
    """timestamp -> 'yyyy-MM-dd HH:mm:ss[.ffffff]', the fraction present
    when nonzero with its trailing zeros trimmed (Spark)."""
    cap, dev = micros.shape[0], micros.device
    date_part, _ = _date_to_string(DT.micros_to_date_days(micros))
    h, mnt, s, us = DT.micros_time_of_day(micros)

    def const(ch):
        return torch.full((cap, 1), ord(ch), dtype=torch.uint8, device=dev)
    base = torch.cat([date_part, const(" "), _pad2(h), const(":"),
                      _pad2(mnt), const(":"), _pad2(s)], dim=1)  # width 19
    digs = torch.stack([torch.remainder(DT.floor_div(us, 10 ** (5 - k)), 10)
                        for k in range(6)], dim=1)
    frac = torch.cat([const("."), (digs + ord("0")).to(torch.uint8)], dim=1)
    # trailing zeros of the fraction
    tz = torch.zeros(cap, dtype=torch.int32, device=dev)
    running = torch.ones(cap, dtype=torch.bool, device=dev)
    for k in range(5, -1, -1):
        running = running & (digs[:, k] == 0)
        tz = tz + running.to(torch.int32)
    frac_len = torch.where(us != 0, 7 - tz, 0)
    out = torch.cat([base, frac], dim=1)
    length = 19 + frac_len
    out = torch.where(_positions(out.shape[1], dev) < length[:, None], out,
                      0).to(torch.uint8)
    return out, length.to(torch.int32)


def _to_string(c: ColumnVector) -> ColumnVector:
    dev = c.device
    if c.dtype.id == T.TypeId.BOOL:
        t = np.zeros(5, np.uint8)
        t[:4] = np.frombuffer(b"true", np.uint8)
        f = np.frombuffer(b"false", np.uint8)
        data = torch.where(c.data[:, None], _table(t, torch.uint8, dev)[None],
                           _table(f, torch.uint8, dev)[None])
        lengths = torch.where(c.data, 4, 5).to(torch.int32)
        return ColumnVector(T.STRING, data.to(torch.uint8), c.validity,
                            lengths=lengths)
    if c.dtype.id == T.TypeId.DATE32:
        data, lengths = _date_to_string(c.data)
    elif c.dtype.id == T.TypeId.TIMESTAMP_US:
        data, lengths = _timestamp_to_string(c.data)
    elif c.dtype.is_integral:
        data, lengths = _int_to_string(c.data)
    elif c.dtype.is_floating:
        # conf-gated (castFloatToString.enabled): shortest round trip in
        # Java's notation
        data, lengths = _float_to_string(c.data,
                                         c.dtype.id == T.TypeId.FLOAT32)
    else:
        raise NotImplementedError(f"cast {c.dtype} -> string")
    return ColumnVector(T.STRING, data, c.validity, lengths=lengths)


# --------------------------------------------------------------------------
# float -> string: the shortest decimal that reads back to the same
# value, in Java's Double.toString notation (plain for 1e-3 <= |x| <
# 1e7, scientific outside).  Every product and sum below is its own
# torch op, rounded once: a fused multiply-add would change the last
# digit of the error-free transforms.
_P10F = np.array([float(f"1e{k}") for k in range(-323, 309)])
_P10I = np.array([10 ** k for k in range(10)], dtype=np.int32)
_FLOAT_STR_WIDTH = 26


def _pow10_mul(x, k):
    """x * 10^k with k possibly outside float64's exact range: 10^j is
    exact for j <= 22, so up to |k| 44 two exact factors (one extra
    rounding), past that a correctly rounded table factor.  A negative k
    divides (multiplying by an inexact reciprocal would double-round)."""
    return _pow10_scaled(x, k, 22)


def _pow10_scaled(x, k, first: int):
    p10 = _table(_P10F, torch.float64, x.device)

    def at(j):
        # an index past the table reads its last entry, as the
        # reference's clamped gather does
        return p10[torch.clamp(j + 323, 0, len(_P10F) - 1).long()]
    posk = torch.clamp(k, min=0)
    a1 = torch.clamp(posk, max=first)
    a2 = torch.clamp(posk - a1, max=22)
    a3 = torch.clamp(posk - a1 - a2, 0, 308)
    x = x * at(a1)
    x = x * at(a2)
    x = x * at(a3)
    j = -torch.clamp(k, max=0)
    b1 = torch.clamp(j, max=first)
    b2 = torch.clamp(j - b1, max=22)
    b3 = torch.clamp(j - b1 - b2, 0, 323)
    x = x / at(b1)
    x = x / at(b2)
    return x / at(b3)


def _dec_exponent(a):
    """floor(log10(a)) for finite positive a: a binary search of the
    correctly rounded power-of-ten table, as the reference does."""
    p10 = _table(_P10F, torch.float64, a.device)
    lo = torch.full(a.shape, -324, dtype=torch.int32, device=a.device)
    hi = torch.full(a.shape, 308, dtype=torch.int32, device=a.device)
    for _ in range(11):  # 2^11 > 633 candidate exponents
        mid = DT.floor_div(lo + hi + 1, 2)
        ge = a >= p10[(torch.clamp(mid, -323, 308) + 323).long()]
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid - 1)
    return lo


# double-double helpers: error-free transforms (Dekker's TwoProd without
# FMA, Knuth's TwoSum) give ~106-bit arithmetic, enough to round and
# verify 17 decimal digits exactly
_DD_SPLIT = 134217729.0  # 2^27 + 1


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _prescale(a):
    """An exact power of two that keeps the Dekker split away from
    overflow (|x| > ~6.7e300) and its error term out of subnormals."""
    return torch.where(torch.abs(a) > 1e250, 2.0 ** -64,
                       torch.where((torch.abs(a) < 1e-250) & (a != 0),
                                   2.0 ** 64, 1.0)).to(torch.float64)


def _two_prod(a, b):
    sa, sb = _prescale(a), _prescale(b)
    a2 = a * sa
    b2 = b * sb
    p2 = a2 * b2
    aa = _DD_SPLIT * a2
    ah = aa - (aa - a2)
    al = a2 - ah
    bb = _DD_SPLIT * b2
    bh = bb - (bb - b2)
    bl = b2 - bh
    t1 = ah * bh
    t1 = t1 - p2
    t2 = ah * bl
    t1 = t1 + t2
    t3 = al * bh
    t1 = t1 + t3
    t4 = al * bl
    err2 = t1 + t4
    inv = (1.0 / sa) * (1.0 / sb)
    return p2 * inv, err2 * inv


def _dd_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    x1 = ah * bl
    x2 = al * bh
    e = e + (x1 + x2)
    return _two_sum(p, e)


def _build_p10_dd():
    """10^k as (hi, lo) double pairs for k in [-340, 340]: the port's
    own copy of the reference's table, from exact fractions."""
    from fractions import Fraction
    his, los = [], []
    for k in range(-340, 341):
        f = Fraction(10) ** k
        try:
            hi = float(f)
        except OverflowError:
            hi = float("inf")
        lo = 0.0 if hi in (0.0, float("inf")) else float(f - Fraction(hi))
        his.append(hi)
        los.append(lo)
    return np.array(his), np.array(los)


_P10DD_HI, _P10DD_LO = _build_p10_dd()
_P10DD_OFF = 340


def _pow10_dd(x, k):
    """x (an exact double) * 10^k in double-double, as 10^kA * 10^kB
    with |kA| <= 160, so no factor passes the Dekker split's overflow
    bound."""
    hi_t = _table(_P10DD_HI, torch.float64, x.device)
    lo_t = _table(_P10DD_LO, torch.float64, x.device)
    kA = torch.clamp(k, -160, 160)
    kB = torch.clamp(k - kA, -_P10DD_OFF, _P10DD_OFF)
    ia, ib = (kA + _P10DD_OFF).long(), (kB + _P10DD_OFF).long()
    h, l = _dd_mul(x, torch.zeros_like(x), hi_t[ia], lo_t[ia])
    return _dd_mul(h, l, hi_t[ib], lo_t[ib])


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None].long())[:, 0]


def _float_to_string(values: torch.Tensor, is_f32: bool):
    dev = values.device
    x = values.to(torch.float64)
    neg = torch.signbit(x)
    nan = torch.isnan(x)
    neg = neg & ~nan
    inf = torch.isinf(x)
    zero = x == 0.0
    a = torch.where(nan | inf | zero, 1.0, torch.abs(x))

    e = _dec_exponent(a)  # a in [10^e, 10^(e+1))

    P = 9 if is_f32 else 17
    pcol = torch.arange(1, P + 1, dtype=torch.int32, device=dev)[None, :]
    scale_k = e[:, None] - pcol + 1
    # p-digit decimal rounding of a, in double-double so mantissas past
    # 2^53 (p = 16, 17) still round to the true decimal digits
    ab = a[:, None].expand(-1, P)
    mh, ml = _pow10_dd(ab, -scale_k)
    mi = torch.round(mh)
    corr = torch.round((mh - mi) + ml)   # mh - mi is exact
    p10f = _table(_P10F, torch.float64, dev)
    # rounding may carry to p + 1 digits (M == 10^p): renormalize
    pw = p10f[(torch.clamp(pcol, -323, 308) + 323).long()]
    carry = (mi + corr) >= pw
    mi = torch.where(carry, p10f[(torch.clamp(pcol - 1, -323, 308)
                                  + 323).long()].expand_as(mi), mi)
    corr = torch.where(carry, 0.0, corr)
    e2 = e[:, None] + carry.to(torch.int32)
    # the round trip in double-double: nearest double of M * 10^k == a
    k_back = e2 - pcol + 1
    v1h, v1l = _pow10_dd(mi, k_back)
    v2h, v2l = _pow10_dd(corr, k_back)
    sh, se = _two_sum(v1h, v2h)
    vh, vl = _two_sum(sh, ((se + v1l) + v2l))
    if is_f32:
        ok = (vh + vl).to(torch.float32) == ab.to(torch.float32)
    else:
        ok = vh == ab
    any_ok = ok.any(dim=1)
    pidx = torch.where(any_ok, first_true(ok), P - 1)
    p_sel = (pidx + 1).to(torch.int32)
    mi_sel = _take(mi, pidx)
    corr_sel = _take(corr, pidx)
    e_sel = _take(e2, pidx)

    # M = mi + corr as two decimal int32 halves (exact past 2^53 through
    # an error-free q * 1e8 product)
    q = torch.floor(true_divide(mi_sel, 1e8))
    r_p, r_e = _two_prod(q, torch.full_like(q, 1e8))
    rem = ((mi_sel - r_p) - r_e) + corr_sel
    q = torch.where(rem < 0, q - 1, q)
    rem = torch.where(rem < 0, rem + 1e8, rem)
    q = torch.where(rem >= 1e8, q + 1, q)
    rem = torch.where(rem >= 1e8, rem - 1e8, rem)
    m_hi = q.to(torch.int32)     # <= 10^9
    m_lo = rem.to(torch.int32)   # < 10^8
    p10i = _table(_P10I, torch.int32, dev)

    def fdiv(a_, b_):
        return torch.div(a_, b_, rounding_mode="floor")

    # strip trailing zero digits: m * 10^k and (m / 10) * 10^(k + 1)
    # denote the same decimal, so the shorter mantissa is always valid
    tz = torch.zeros_like(m_hi)
    running = torch.ones(m_hi.shape, dtype=torch.bool, device=dev)
    for t in range(17):
        if t < 8:
            d = torch.remainder(fdiv(m_lo, int(_P10I[t])), 10)
        else:
            d = torch.remainder(fdiv(m_hi, int(_P10I[t - 8])), 10)
        running = running & (d == 0)
        tz = tz + running.to(torch.int32)
    z = torch.minimum(tz, p_sel - 1)
    zlo = torch.clamp(z, 0, 8).long()
    zhi = torch.clamp(z - 8, 0, 9).long()
    lo_le8 = (torch.remainder(m_hi, p10i[zlo]) * p10i[8 - zlo]
              + fdiv(m_lo, p10i[zlo]))
    hi_le8 = fdiv(m_hi, p10i[zlo])
    tmp_gt8 = fdiv(m_hi, p10i[zhi])
    m_hi = torch.where(z <= 8, hi_le8, 0)
    m_lo = torch.where(z <= 8, lo_le8, tmp_gt8)
    p_sel = p_sel - z

    def digit_at(idx):
        """Digit `idx` of the p_sel significant ones (0 = most
        significant); '0' out of range."""
        w = p_sel[:, None] - 1 - idx          # decimal weight, 0 = units
        whi = torch.clamp(w - 8, 0, 9).long()
        wlo = torch.clamp(w, 0, 9).long()
        d = torch.where(w >= 8,
                        torch.remainder(fdiv(m_hi[:, None], p10i[whi]), 10),
                        torch.remainder(fdiv(m_lo[:, None], p10i[wlo]), 10))
        return torch.where((idx >= 0) & (idx < p_sel[:, None]), d, 0)

    E = e_sel
    plain = (E >= -3) & (E < 7)
    int_len = torch.where(plain & (E >= 0), E + 1, 1)
    frac_len = torch.where(
        plain,
        torch.where(E >= 0, torch.clamp(p_sel - E - 1, min=1),
                    (-E - 1) + p_sel),
        torch.clamp(p_sel - 1, min=1))
    absE = torch.abs(E)
    exp_digits = (1 + (absE >= 10).to(torch.int32)
                  + (absE >= 100).to(torch.int32))
    exp_neg = (E < 0).to(torch.int32)
    sci_extra = torch.where(plain, 0, 1 + exp_neg + exp_digits)
    negi = neg.to(torch.int32)
    length = negi + int_len + 1 + frac_len + sci_extra

    W = _FLOAT_STR_WIDTH
    pos = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    jj = pos - negi[:, None]                                 # after sign
    il, fl = int_len[:, None], frac_len[:, None]
    int_idx = torch.where(plain[:, None] & (E[:, None] >= 0), jj, 0)
    int_ch = digit_at(int_idx) + ord("0")
    int_ch = torch.where(plain[:, None] & (E[:, None] < 0), ord("0"), int_ch)
    k = jj - il - 1                       # index into the fraction
    frac_idx = torch.where(plain[:, None], k + E[:, None] + 1, k + 1)
    frac_ch = digit_at(frac_idx) + ord("0")
    jE = k - fl                           # index into 'E[-]digits'
    ed = exp_digits[:, None]
    exp_w = torch.clamp(ed - jE + exp_neg[:, None], 0, 9).long()
    exp_digit = torch.remainder(fdiv(absE[:, None], p10i[exp_w]), 10)
    suffix_ch = torch.where(
        jE == 0, ord("E"),
        torch.where((jE == 1) & (exp_neg[:, None] == 1), ord("-"),
                    exp_digit + ord("0")))
    out = torch.where(
        (pos == 0) & neg[:, None], ord("-"),
        torch.where(jj < il, int_ch,
                    torch.where(jj == il, ord("."),
                                torch.where(k < fl, frac_ch, suffix_ch))))
    out = torch.where(pos < length[:, None], out, 0).to(torch.uint8)

    def fixed(s: str):
        b = np.zeros(W, np.uint8)
        b[:len(s)] = np.frombuffer(s.encode(), np.uint8)
        return _table(b, torch.uint8, dev)[None, :], len(s)

    for mask, s in ((nan, "NaN"), (inf & ~neg, "Infinity"),
                    (inf & neg, "-Infinity"), (zero & ~neg, "0.0"),
                    (zero & neg, "-0.0")):
        b, n = fixed(s)
        out = torch.where(mask[:, None], b, out)
        length = torch.where(mask, n, length)
    return out, length.to(torch.int32)


# --------------------------------------------------------------------------
# from string
def _from_string(c: ColumnVector, dst: T.DataType) -> ColumnVector:
    if dst.is_integral and dst.id not in (T.TypeId.DATE32,
                                          T.TypeId.TIMESTAMP_US):
        return _string_to_int(c, dst)
    if dst.is_floating:
        # conf-gated (castStringToFloat.enabled)
        return _string_to_float(c, dst)
    if dst.id == T.TypeId.DATE32:
        return _string_to_date(c)
    if dst.id == T.TypeId.TIMESTAMP_US:
        # conf-gated (castStringToTimestamp.enabled): canonical forms
        return _string_to_timestamp(c)
    if dst.id == T.TypeId.BOOL:
        return _string_to_bool(c)
    raise NotImplementedError(f"cast string -> {dst}")


def _ci_match(chars, lens, word: str):
    """Case-insensitive whole-string match against an ASCII word (the
    caller trims).  chars: int32 [cap, cc]."""
    n = len(word)
    if n > chars.shape[1]:
        return torch.zeros(chars.shape[0], dtype=torch.bool,
                           device=chars.device)
    lower = torch.where((chars >= ord("A")) & (chars <= ord("Z")),
                        chars + 32, chars)
    eq = lens == n
    for i, b in enumerate(word.lower().encode()):
        eq = eq & (lower[:, i] == b)
    return eq


def _trimmed(c: ColumnVector):
    """(chars int32, start, length) with every byte <= 0x20 trimmed from
    both ends (Spark's UTF8String.trimAll)."""
    cc = c.char_cap
    chars = c.data.to(torch.int32)
    in_str = _positions(cc, c.device) < c.lengths[:, None]
    nonspace = in_str & (chars > 0x20)
    anyns = nonspace.any(dim=1)
    first = torch.where(anyns, first_true(nonspace), c.lengths)
    last = torch.where(anyns, (cc - 1) - first_true(nonspace.flip(1)),
                       c.lengths - 1)
    return chars, first, torch.clamp(last - first + 1, min=0)


def _shift_left(chars, start, cc):
    """Gather so that the trimmed string starts at column 0."""
    idx = torch.clamp(start[:, None] + _positions(cc, chars.device), 0,
                      cc - 1)
    return torch.gather(chars, 1, idx.long())


def _string_to_bool(c: ColumnVector) -> ColumnVector:
    """Spark's isTrueString/isFalseString: t/true/y/yes/1 and
    f/false/n/no/0 (case-insensitive, trimmed); anything else null."""
    chars, start, tlen = _trimmed(c)
    sh = _shift_left(chars, start, c.char_cap)
    is_true = torch.zeros(c.capacity, dtype=torch.bool, device=c.device)
    for w in ("t", "true", "y", "yes", "1"):
        is_true = is_true | _ci_match(sh, tlen, w)
    is_false = torch.zeros_like(is_true)
    for w in ("f", "false", "n", "no", "0"):
        is_false = is_false | _ci_match(sh, tlen, w)
    return ColumnVector(T.BOOL, is_true, c.validity & (is_true | is_false))


def _string_to_float(c: ColumnVector, dst: T.DataType) -> ColumnVector:
    """Trimmed decimal parse with an optional fraction and exponent, and
    Spark's inf/+inf/-inf/infinity/nan (case-insensitive)."""
    cc, cap, dev = c.char_cap, c.capacity, c.device
    chars, start, tlen = _trimmed(c)
    sh = _shift_left(chars, start, cc)

    sign_ch = sh[:, 0]
    has_sign = ((sign_ch == ord("-")) | (sign_ch == ord("+"))) & (tlen > 0)
    neg = (sign_ch == ord("-")) & has_sign

    # the specials, an optional sign consumed
    body = torch.where(has_sign[:, None],
                       _shift_left(sh, torch.ones_like(start), cc), sh)
    blen = tlen - has_sign.to(tlen.dtype)
    special_inf = _ci_match(body, blen, "inf") | \
        _ci_match(body, blen, "infinity")
    special_nan = _ci_match(body, blen, "nan")

    dig = body - ord("0")
    is_digit = (dig >= 0) & (dig <= 9)
    is_dot = body == ord(".")
    is_exp = (body == ord("e")) | (body == ord("E"))
    bpos = _positions(cc, dev)
    in_body = bpos < blen[:, None]

    # the first e/E and the first dot
    exp_m = is_exp & in_body
    has_exp = exp_m.any(dim=1)
    exp_at = torch.where(has_exp, first_true(exp_m), blen)
    dot_m = is_dot & in_body
    has_dot = dot_m.any(dim=1)
    dot_at = torch.where(has_dot, first_true(dot_m), blen)

    mant_region = in_body & (bpos < exp_at[:, None])
    mant_digits = mant_region & is_digit
    bad_mant = mant_region & ~is_digit & ~is_dot
    ndots = (is_dot & mant_region).sum(dim=1)
    n_mant = mant_digits.sum(dim=1)
    dot_after_exp = has_dot & (dot_at > exp_at)

    # up to 18 significant mantissa digits; leading zeros take no room,
    # zeros after the dot before the first significant digit still
    # shift the exponent; integer digits past the room scale by 10
    acc = torch.zeros(cap, dtype=torch.int64, device=dev)
    taken = torch.zeros(cap, dtype=torch.int32, device=dev)
    skipped = torch.zeros(cap, dtype=torch.int32, device=dev)
    frac_cnt = torch.zeros(cap, dtype=torch.int32, device=dev)
    sig_started = torch.zeros(cap, dtype=torch.bool, device=dev)
    first_dropped = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    for kcol in range(cc):
        isd = mant_digits[:, kcol]
        dk = dig[:, kcol]
        lead_zero = isd & ~sig_started & (dk == 0)
        sig_started = sig_started | (isd & (dk != 0))
        room = taken < 18
        take = isd & ~lead_zero & room
        acc = torch.where(take, acc * 10 + dk.to(torch.int64), acc)
        taken = taken + take.to(torch.int32)
        after_dot = has_dot & (kcol > dot_at) & ~dot_after_exp
        dropped = isd & ~lead_zero & ~room
        first_dropped = torch.where(dropped & (first_dropped < 0), dk,
                                    first_dropped)
        skipped = skipped + (dropped & ~after_dot).to(torch.int32)
        frac_cnt = frac_cnt + (isd & after_dot & (take | lead_zero)).to(
            torch.int32)
    # round half up on the 19th significant digit
    acc = torch.where(first_dropped >= 5, acc + 1, acc)

    # the exponent: a sign and digits, saturating at 99999 so that
    # '1e99999' overflows to Infinity as in Java
    epos0 = exp_at + 1
    esign_ch = torch.gather(body, 1, torch.clamp(epos0, 0, cc - 1)[:, None]
                            .long())[:, 0]
    e_has_sign = (esign_ch == ord("-")) | (esign_ch == ord("+"))
    e_neg = esign_ch == ord("-")
    edig_start = epos0 + e_has_sign.to(epos0.dtype)
    exp_region = in_body & (bpos >= edig_start[:, None])
    n_edig = (exp_region & is_digit).sum(dim=1)
    bad_exp = has_exp & ((exp_region & ~is_digit).any(dim=1) | (n_edig < 1))
    eval_ = torch.zeros(cap, dtype=torch.int32, device=dev)
    for kcol in range(cc):
        use = exp_region[:, kcol] & is_digit[:, kcol]
        eval_ = torch.where(use, torch.clamp(eval_ * 10 + dig[:, kcol],
                                             max=99999), eval_)
    eval_ = torch.where(e_neg & has_exp, -eval_, eval_)

    total_exp = eval_ + skipped - frac_cnt
    value = _pow10_mul(acc.to(torch.float64), total_exp)
    value = torch.where(neg, -value, value)

    ok = ((n_mant >= 1) & (ndots <= 1) & ~bad_mant.any(dim=1) & ~bad_exp
          & ~dot_after_exp & (tlen > 0))
    inf = torch.where(neg, -float("inf"), float("inf")).to(torch.float64)
    value = torch.where(special_inf, inf, value)
    value = torch.where(special_nan, float("nan"), value)
    ok = ok | special_inf | special_nan
    return ColumnVector(dst, value.to(dst.torch_dtype), c.validity & ok)


def _string_to_timestamp(c: ColumnVector) -> ColumnVector:
    """'yyyy-MM-dd', 'yyyy-MM-dd HH:mm:ss' and 'yyyy-MM-dd
    HH:mm:ss.ffffff' (1-6 fraction digits), UTC only, trimmed first."""
    cc = max(c.char_cap, 26)
    c = _pad_chars(c, cc)
    tchars, tstart, tlen = _trimmed(c)
    chars = _shift_left(tchars, tstart, cc)
    lens = tlen
    date_part = ColumnVector(T.STRING, chars.to(torch.uint8)[:, :10],
                             c.validity, lengths=torch.clamp(lens, max=10))
    days = _string_to_date(date_part)
    dig = (chars - ord("0")).to(torch.int64)

    def is_d(k):
        return (dig[:, k] >= 0) & (dig[:, k] <= 9)

    date_only = lens == 10
    has_time = lens >= 19
    sep_ok = ((chars[:, 10] == ord(" ")) & (chars[:, 13] == ord(":"))
              & (chars[:, 16] == ord(":")))
    tdig_ok = torch.ones(c.capacity, dtype=torch.bool, device=c.device)
    for k in (11, 12, 14, 15, 17, 18):
        tdig_ok = tdig_ok & is_d(k)
    h = dig[:, 11] * 10 + dig[:, 12]
    mnt = dig[:, 14] * 10 + dig[:, 15]
    s = dig[:, 17] * 10 + dig[:, 18]
    t_ok = has_time & sep_ok & tdig_ok & (h < 24) & (mnt < 60) & (s < 60)

    has_frac = lens > 19
    frac_ok = has_frac & (chars[:, 19] == ord(".")) & (lens <= 26)
    us = torch.zeros(c.capacity, dtype=torch.int64, device=c.device)
    ndig = torch.zeros(c.capacity, dtype=torch.int32, device=c.device)
    for k in range(20, 26):
        in_frac = k < lens
        d_ok = is_d(k)
        frac_ok = frac_ok & (~in_frac | d_ok)
        us = torch.where(in_frac & d_ok, us * 10 + dig[:, k], us)
        ndig = ndig + (in_frac & d_ok).to(torch.int32)
    scale = _table([10 ** k for k in range(7)], torch.int64, c.device)
    us = us * scale[torch.clamp(6 - ndig, 0, 6).long()]
    frac_valid = torch.where(has_frac, frac_ok & (ndig >= 1), True)

    time_us = torch.where(
        date_only, 0,
        (h * 3600 + mnt * 60 + s) * DT.MICROS_PER_SECOND + us)
    micros = days.data.to(torch.int64) * DT.MICROS_PER_DAY + time_us
    shape_ok = date_only | (t_ok & frac_valid)
    return ColumnVector(T.TIMESTAMP_US, micros, days.validity & shape_ok)


def _string_to_int(c: ColumnVector, dst: T.DataType) -> ColumnVector:
    """Decimal parse with spaces trimmed; invalid or overflowing gives
    null (Spark)."""
    cc, cap, dev = c.char_cap, c.capacity, c.device
    chars = c.data.to(torch.int32)
    lens = c.lengths.to(torch.int64)
    pos = _positions(cc, dev)
    in_str = pos < lens[:, None]
    is_space = (chars == ord(" ")) & in_str
    nonspace = ~is_space & in_str
    lead = torch.where(nonspace.any(dim=1), first_true(nonspace), lens)
    last = torch.where(nonspace.any(dim=1),
                       (cc - 1) - first_true(nonspace.flip(1)), -1)
    sign_char = torch.gather(chars, 1, torch.clamp(lead, max=cc - 1)
                             [:, None])[:, 0]
    has_sign = (sign_char == ord("-")) | (sign_char == ord("+"))
    neg = sign_char == ord("-")
    start = lead + has_sign.to(torch.int64)
    ndigits = last - start + 1
    in_digits = (pos >= start[:, None]) & (pos <= last[:, None])
    dig = chars - ord("0")
    digit_ok = (dig >= 0) & (dig <= 9)
    # significant digits (leading zeros allowed, as Long.parseLong)
    sig = in_digits & (dig != 0)
    first_sig = torch.where(sig.any(dim=1), first_true(sig), last + 1)
    sig_digits = torch.clamp(last - first_sig + 1, min=0)
    # Horner in 64 bits: 19 significant digits cannot wrap unsigned
    # (10^19 - 1 < 2^64), so overflow is an exact unsigned compare
    acc = torch.zeros(cap, dtype=torch.int64, device=dev)
    for k in range(cc):
        acc = torch.where(in_digits[:, k],
                          acc * 10 + dig[:, k].to(torch.int64), acc)
    limit = torch.where(neg, _I64_MIN, 2 ** 63 - 1)   # 2^63 unsigned
    valid_parse = ((ndigits >= 1) & (sig_digits <= 19) & _ule(acc, limit)
                   & torch.where(in_digits, digit_ok, True).all(dim=1))
    # -acc wraps 2^63 to INT64_MIN, as the reference's select does
    val = torch.where(neg, -acc, acc)
    lo, hi = _bounds(dst)
    in_range = (val >= lo) & (val <= hi)
    return ColumnVector(dst, val.to(dst.torch_dtype),
                        c.validity & valid_parse & in_range)


def _string_to_date(c: ColumnVector) -> ColumnVector:
    """'yyyy-MM-dd' only; anything else (and an impossible date such as
    Feb 31) is null."""
    c = _pad_chars(c, max(c.char_cap, 10))
    chars = c.data.to(torch.int64)
    dig = chars - ord("0")

    def num(cols):
        out = torch.zeros(c.capacity, dtype=torch.int64, device=c.device)
        for k in cols:
            out = out * 10 + dig[:, k]
        return out

    digits_ok = torch.ones(c.capacity, dtype=torch.bool, device=c.device)
    for k in (0, 1, 2, 3, 5, 6, 8, 9):
        digits_ok = digits_ok & (dig[:, k] >= 0) & (dig[:, k] <= 9)
    dashes_ok = (chars[:, 4] == ord("-")) & (chars[:, 7] == ord("-"))
    y, m, d = num((0, 1, 2, 3)), num((5, 6)), num((8, 9))
    range_ok = (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
    days = DT.ymd_to_days(y, m, d)
    # an impossible date normalizes to another: the round trip must give
    # the parsed fields back
    ry, rm, rd = DT.days_to_ymd(days)
    exact = (ry == y) & (rm == m) & (rd == d)
    validity = (c.validity & (c.lengths == 10) & digits_ok & dashes_ok
                & range_ok & exact)
    return ColumnVector(T.DATE32, days, validity)
