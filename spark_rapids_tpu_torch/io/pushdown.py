"""Statistics-based predicate pushdown for file scans (port of
spark_rapids_tpu/io/pushdown.py; it runs on the host).

Parquet-mr's row-group filtering and ORC's SearchArgument pushdown play
this role in Spark: given per-chunk column statistics (min/max/null
counts), decide whether a row group or stripe *might* contain rows
matching the scan filter.

Tri-state logic: `might_match` returns False only when the statistics
*prove* no row can match; anything unsupported or uncertain keeps the
chunk.  Filters are the same `Expression` AST the execs evaluate, so a
pushed-down filter is still re-applied post-scan for exactness.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from spark_rapids_tpu_torch.exprs import predicates as P
from spark_rapids_tpu_torch.exprs.base import (Alias, AttributeReference,
                                               Expression, Literal)


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Min/max are None when the writer recorded no stats (treat as
    unbounded).  `num_values` is the chunk row count."""
    min: Any = None
    max: Any = None
    null_count: Optional[int] = None
    num_values: Optional[int] = None

    @property
    def all_null(self) -> bool:
        return (self.null_count is not None and self.num_values is not None
                and self.null_count >= self.num_values)

    @property
    def has_nulls(self) -> bool:
        return self.null_count is None or self.null_count > 0


def might_match(filter_expr: Optional[Expression],
                stats: dict[str, ColumnStats]) -> bool:
    """True unless `stats` prove no row in the chunk satisfies the filter."""
    if filter_expr is None:
        return True
    return _may(filter_expr, stats)


def _col_of(e: Expression) -> Optional[str]:
    if isinstance(e, AttributeReference):
        return e.name
    if isinstance(e, Alias):
        return _col_of(e.child)
    return None


def _lit_of(e: Expression):
    if isinstance(e, Literal):
        return e.value
    return _MISSING


_MISSING = object()


def _cmp_args(e) -> Optional[tuple[str, Any, str]]:
    """Normalize `col OP lit` / `lit OP col` to (col, lit, op) with the
    comparison flipped when the literal is on the left."""
    op = type(e).__name__
    c, v = _col_of(e.left), _lit_of(e.right)
    if c is not None and v is not _MISSING:
        return c, v, op
    c, v = _col_of(e.right), _lit_of(e.left)
    if c is not None and v is not _MISSING:
        flip = {"LessThan": "GreaterThan", "GreaterThan": "LessThan",
                "LessThanOrEqual": "GreaterThanOrEqual",
                "GreaterThanOrEqual": "LessThanOrEqual",
                "EqualTo": "EqualTo"}
        return c, v, flip.get(op, op)
    return None


def _may(e: Expression, stats: dict[str, ColumnStats]) -> bool:
    if isinstance(e, P.And):
        return _may(e.left, stats) and _may(e.right, stats)
    if isinstance(e, P.Or):
        return _may(e.left, stats) or _may(e.right, stats)
    if isinstance(e, Literal):
        return e.value is not False and e.value is not None
    if isinstance(e, P.IsNull):
        c = _col_of(e.children()[0])
        if c is not None and c in stats:
            return stats[c].has_nulls
        return True
    if isinstance(e, P.IsNotNull):
        c = _col_of(e.children()[0])
        if c is not None and c in stats:
            return not stats[c].all_null
        return True
    if isinstance(e, P.InSet):
        c = _col_of(e.child)
        if c is None or c not in stats:
            return True
        return any(_range_may(stats[c], v, "EqualTo")
                   for v in e.values if v is not None)
    if isinstance(e, (P.EqualTo, P.LessThan, P.LessThanOrEqual,
                      P.GreaterThan, P.GreaterThanOrEqual)):
        norm = _cmp_args(e)
        if norm is None:
            return True
        col, val, op = norm
        if col not in stats or val is None:
            # comparison with null literal matches nothing, but stay
            # conservative for unknown columns
            return val is not None if col in stats else True
        return _range_may(stats[col], val, op)
    # Not / StartsWith / arbitrary expressions: keep the chunk
    return True


def _range_may(s: ColumnStats, val, op: str) -> bool:
    """Can any non-null value in [s.min, s.max] satisfy `value OP val`?"""
    if s.all_null:
        return False
    try:
        if op == "EqualTo":
            if s.min is not None and _lt(val, s.min):
                return False
            if s.max is not None and _lt(s.max, val):
                return False
        elif op == "LessThan":
            if s.min is not None and not _lt(s.min, val):
                return False
        elif op == "LessThanOrEqual":
            if s.min is not None and _lt(val, s.min):
                return False
        elif op == "GreaterThan":
            if s.max is not None and not _lt(val, s.max):
                return False
        elif op == "GreaterThanOrEqual":
            if s.max is not None and _lt(s.max, val):
                return False
    except TypeError:
        return True  # incomparable stat/literal types (e.g. after cast)
    return True


def _lt(a, b) -> bool:
    # date/timestamp stats may surface as datetime while literals are
    # int32 days / int64 micros; normalize via ordinal comparison
    import datetime
    import numpy as np
    if isinstance(a, (datetime.date, datetime.datetime, np.datetime64)):
        a = _to_epoch(a)
    if isinstance(b, (datetime.date, datetime.datetime, np.datetime64)):
        b = _to_epoch(b)
    return a < b


def _to_epoch(v):
    import datetime
    import numpy as np
    if isinstance(v, np.datetime64):
        return v.astype("datetime64[us]").astype(np.int64).item()
    if isinstance(v, datetime.datetime):
        return int(v.replace(tzinfo=datetime.timezone.utc).timestamp() * 1e6)
    return (v - datetime.date(1970, 1, 1)).days
