"""Misc expressions (port of spark_rapids_tpu/exprs/misc.py): the task
identity expressions, rand(seed), NaN/zero normalization and the
constraint markers.

`Rand` draws the reference's stream bit for bit: JAX's threefry2x32
(`jax.random.key(seed)`, `fold_in(row_offset)`, then `uniform` in its
partitionable counter layout), written here in int64 torch ops so the
values do not depend on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import ColumnVector
from spark_rapids_tpu_torch.exprs.base import (EvalContext, Expression,
                                               UnaryExpression)


@dataclasses.dataclass
class TaskContextInfo:
    """Per-partition execution context, set before a batch evaluates
    expressions that depend on task identity (the analog of Spark's
    TaskContext and InputFileBlockHolder)."""
    partition_id: int = 0
    row_offset: int = 0          # rows emitted before this batch
    input_file: str = ""
    input_file_offset: int = 0
    input_file_length: int = 0


_ACTIVE_TASK = TaskContextInfo()


def set_task_context(info: TaskContextInfo) -> None:
    global _ACTIVE_TASK
    _ACTIVE_TASK = info


def get_task_context() -> TaskContextInfo:
    return _ACTIVE_TASK


class _Leaf(Expression):
    """A leaf that reads the task context, not a column."""

    def bind(self, schema):
        return self


def _full(ctx: EvalContext, value, dt: T.DataType) -> ColumnVector:
    data = torch.full((ctx.capacity,), value, dtype=dt.torch_dtype,
                      device=ctx.device)
    return ColumnVector(dt, data, ctx.row_mask)


@dataclasses.dataclass(eq=False)
class MonotonicallyIncreasingID(_Leaf):
    """(partition_id << 33) + row index within the partition, as in
    Spark."""

    def data_type(self, schema):
        return T.INT64

    def eval(self, ctx):
        tc = get_task_context()
        base = (tc.partition_id << 33) + tc.row_offset
        data = torch.arange(ctx.capacity, dtype=torch.int64,
                            device=ctx.device) + base
        return ColumnVector(T.INT64, data, ctx.row_mask)


@dataclasses.dataclass(eq=False)
class SparkPartitionID(_Leaf):
    def data_type(self, schema):
        return T.INT32

    def eval(self, ctx):
        return _full(ctx, get_task_context().partition_id, T.INT32)


@dataclasses.dataclass(eq=False)
class InputFileName(_Leaf):
    def data_type(self, schema):
        return T.STRING

    def eval(self, ctx):
        from spark_rapids_tpu_torch.exprs.base import Literal
        return Literal(get_task_context().input_file, T.STRING).eval(ctx)


@dataclasses.dataclass(eq=False)
class InputFileBlockStart(_Leaf):
    def data_type(self, schema):
        return T.INT64

    def eval(self, ctx):
        return _full(ctx, get_task_context().input_file_offset, T.INT64)


@dataclasses.dataclass(eq=False)
class InputFileBlockLength(_Leaf):
    def data_type(self, schema):
        return T.INT64

    def eval(self, ctx):
        return _full(ctx, get_task_context().input_file_length, T.INT64)


# -- threefry2x32 in int64 lanes ---------------------------------------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11), as
    `jax.random` applies it: two uint32 key words, two counter words per
    lane.  Words are int64 tensors holding values in [0, 2^32)."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _scalar_threefry(k1: int, k2: int, c0: int, c1: int) -> tuple[int, int]:
    y0, y1 = threefry2x32(k1, k2, torch.tensor([c0], dtype=torch.int64),
                          torch.tensor([c1], dtype=torch.int64))
    return int(y0[0]), int(y1[0])


def uniform_stream(seed: int, fold: int, n: int, device) -> torch.Tensor:
    """`jax.random.uniform(fold_in(key(seed), fold), (n,), float64)`:
    the key is (seed >> 32, seed & 0xFFFFFFFF), fold_in hashes the
    uint32 `fold` under it, and each lane i draws 64 bits from counter
    (0, i): the high word from the first output, the low word from the
    second; the top 52 bits fill a mantissa in [1, 2), less 1."""
    k1, k2 = _scalar_threefry((seed >> 32) & _M32, seed & _M32,
                              0, fold & _M32)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(k1, k2, torch.zeros_like(lanes), lanes)
    mantissa = (hi << 20) | (lo >> 12)
    one = torch.tensor(0x3FF0000000000000, dtype=torch.int64,
                       device=device)
    return (mantissa | one).view(torch.float64) - 1.0


@dataclasses.dataclass(eq=False)
class Rand(_Leaf):
    """rand(seed): uniform [0, 1) from a counter-based stream keyed by
    (seed, partition) and folded with the row offset, so a retry of the
    same batch draws the same values (unlike Spark's per-task
    XORShiftRandom)."""
    seed: int = 0

    def data_type(self, schema):
        return T.FLOAT64

    def eval(self, ctx):
        tc = get_task_context()
        data = uniform_stream(
            (self.seed * 1_000_003 + tc.partition_id) & 0x7FFFFFFF,
            tc.row_offset, ctx.capacity, ctx.device)
        return ColumnVector(T.FLOAT64, data, ctx.row_mask)


@dataclasses.dataclass(eq=False)
class NormalizeNaNAndZero(UnaryExpression):
    """Canonicalize NaN payloads and -0.0 for grouping and join keys
    (Spark's NormalizeFloatingNumbers)."""
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        x = c.data
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                        x)
        x = torch.where(x == 0.0, torch.zeros_like(x), x)  # -0.0 -> +0.0
        return ColumnVector(c.dtype, x, c.validity)


@dataclasses.dataclass(eq=False)
class KnownFloatingPointNormalized(UnaryExpression):
    """Marker wrapper (Spark's constraint expression)."""
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        return c


@dataclasses.dataclass(eq=False)
class KnownNotNull(UnaryExpression):
    child: Expression

    def data_type(self, schema):
        return self.child.data_type(schema)

    def do_columnar(self, c, ctx):
        return ColumnVector(c.dtype, c.data, ctx.row_mask,
                            lengths=c.lengths)
