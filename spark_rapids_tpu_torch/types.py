"""Type system for columnar batches (port of spark_rapids_tpu/types.py):
Boolean/Byte/Short/Int/Long/Float/Double/Date/Timestamp/String.

Spark's 64-bit types stay explicit: LONG is torch.int64 and DOUBLE is
torch.float64 (torch's default float type is float32, so nothing here
relies on a default).  Dates are int32 days since the epoch, timestamps
int64 microseconds since the epoch (UTC only).  Strings are fixed-width
byte tensors: uint8[capacity, char_cap] plus int32 lengths (see
columnar/vector.py).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class TypeId(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"          # days since unix epoch, int32 storage
    TIMESTAMP_US = "timestamp"  # microseconds since epoch UTC, int64 storage
    STRING = "string"          # byte-tensor encoded


@dataclasses.dataclass(frozen=True)
class DataType:
    id: TypeId

    @property
    def is_string(self) -> bool:
        return self.id == TypeId.STRING

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_integral(self) -> bool:
        return self.id in (TypeId.INT8, TypeId.INT16, TypeId.INT32,
                           TypeId.INT64, TypeId.DATE32, TypeId.TIMESTAMP_US)

    @property
    def is_numeric(self) -> bool:
        return self.is_floating or self.id in (
            TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64)

    @property
    def storage_dtype(self) -> np.dtype:
        """numpy dtype of the data buffer."""
        return _STORAGE[self.id]

    @property
    def torch_dtype(self) -> torch.dtype:
        """torch dtype of the data buffer."""
        return _TORCH[self.id]

    def __repr__(self) -> str:
        return self.id.value


BOOL = DataType(TypeId.BOOL)
INT8 = DataType(TypeId.INT8)
INT16 = DataType(TypeId.INT16)
INT32 = DataType(TypeId.INT32)
INT64 = DataType(TypeId.INT64)
FLOAT32 = DataType(TypeId.FLOAT32)
FLOAT64 = DataType(TypeId.FLOAT64)
DATE32 = DataType(TypeId.DATE32)
TIMESTAMP_US = DataType(TypeId.TIMESTAMP_US)
STRING = DataType(TypeId.STRING)

ALL_TYPES = (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, DATE32,
             TIMESTAMP_US, STRING)

_STORAGE = {
    TypeId.BOOL: np.dtype(np.bool_),
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
    TypeId.DATE32: np.dtype(np.int32),
    TypeId.TIMESTAMP_US: np.dtype(np.int64),
    TypeId.STRING: np.dtype(np.uint8),
}

_TORCH = {
    TypeId.BOOL: torch.bool,
    TypeId.INT8: torch.int8,
    TypeId.INT16: torch.int16,
    TypeId.INT32: torch.int32,
    TypeId.INT64: torch.int64,
    TypeId.FLOAT32: torch.float32,
    TypeId.FLOAT64: torch.float64,
    TypeId.DATE32: torch.int32,
    TypeId.TIMESTAMP_US: torch.int64,
    TypeId.STRING: torch.uint8,
}

_FROM_NP = {
    np.dtype(np.bool_): BOOL,
    np.dtype(np.int8): INT8,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.float32): FLOAT32,
    np.dtype(np.float64): FLOAT64,
}

_BY_NAME = {t.id.value: t for t in ALL_TYPES}


def from_numpy_dtype(dt) -> DataType:
    dt = np.dtype(dt)
    if dt.kind in ("U", "S", "O"):
        return STRING
    if dt.kind == "M":  # datetime64
        return TIMESTAMP_US
    if dt not in _FROM_NP:
        raise TypeError(f"unsupported numpy dtype {dt}")
    return _FROM_NP[dt]


def from_name(name: str) -> DataType:
    """Type by its name ("int32", "float64", "date32", ...)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported type name {name!r}") from None


def from_arrow(at) -> DataType:
    """Our type of a pyarrow DataType (scan schema negotiation)."""
    import pyarrow as pa
    for pred, dt in ((pa.types.is_boolean, BOOL), (pa.types.is_int8, INT8),
                     (pa.types.is_int16, INT16), (pa.types.is_int32, INT32),
                     (pa.types.is_int64, INT64),
                     (pa.types.is_float32, FLOAT32),
                     (pa.types.is_float64, FLOAT64),
                     (pa.types.is_date32, DATE32),
                     (pa.types.is_timestamp, TIMESTAMP_US),
                     (pa.types.is_string, STRING),
                     (pa.types.is_large_string, STRING)):
        if pred(at):
            return dt
    raise TypeError(f"unsupported arrow type {at}")


def to_arrow(dt: DataType):
    """The pyarrow DataType of one of ours (timestamps are UTC)."""
    import pyarrow as pa
    return {
        TypeId.BOOL: pa.bool_(),
        TypeId.INT8: pa.int8(),
        TypeId.INT16: pa.int16(),
        TypeId.INT32: pa.int32(),
        TypeId.INT64: pa.int64(),
        TypeId.FLOAT32: pa.float32(),
        TypeId.FLOAT64: pa.float64(),
        TypeId.DATE32: pa.date32(),
        TypeId.TIMESTAMP_US: pa.timestamp("us", tz="UTC"),
        TypeId.STRING: pa.string(),
    }[dt.id]


def common_type(a: DataType, b: DataType) -> DataType:
    """Numeric promotion following Spark's binary arithmetic widening."""
    if a == b:
        return a
    order = [INT8, INT16, INT32, INT64, FLOAT32, FLOAT64]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    raise TypeError(f"no common type for {a}, {b}")


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:
        return f"{self.name}:{self.dtype}{'' if self.nullable else '!'}"


@dataclasses.dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    @staticmethod
    def of(*pairs) -> "Schema":
        out = []
        for p in pairs:
            if isinstance(p, Field):
                out.append(p)
            else:
                name, dtype = p[0], p[1]
                nullable = p[2] if len(p) > 2 else True
                out.append(Field(name, dtype, nullable))
        return Schema(tuple(out))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"
