"""SQL type system.

The analog of the reference's spi/type package
(core/trino-spi/src/main/java/io/trino/spi/type, 50 files). Each SQL type
maps to a fixed-width physical dtype so every value can live in a TPU HBM
array:

- BIGINT/INTEGER -> int64/int32
- DOUBLE         -> float64
- BOOLEAN        -> bool
- DATE           -> int32 days since 1970-01-01
- DECIMAL(p, s)  -> int64 scaled by 10**s (reference spi/type/DecimalType
                    uses int64 for short decimals the same way)
- VARCHAR/CHAR   -> int32 dictionary codes; the byte strings live host-side
                    in the column dictionary (reference
                    spi/block/DictionaryBlock.java:35 is the precedent for
                    dictionary-encoded execution)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataType:
    """Base class for SQL types. Instances are immutable and hashable."""

    name: str

    def __str__(self) -> str:  # pragma: no cover - debug repr
        return self.name

    @property
    def physical_dtype(self) -> np.dtype:
        raise NotImplementedError

    # Orderable in SQL ORDER BY / comparisons.
    comparable: bool = dataclasses.field(default=True, init=False)


@dataclasses.dataclass(frozen=True)
class BigintType(DataType):
    def __init__(self) -> None:
        super().__init__("bigint")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True)
class IntegerType(DataType):
    def __init__(self) -> None:
        super().__init__("integer")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int32)


@dataclasses.dataclass(frozen=True)
class DoubleType(DataType):
    def __init__(self) -> None:
        super().__init__("double")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.float64)


@dataclasses.dataclass(frozen=True)
class BooleanType(DataType):
    def __init__(self) -> None:
        super().__init__("boolean")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.bool_)


@dataclasses.dataclass(frozen=True)
class DateType(DataType):
    """Days since the 1970-01-01 epoch, int32."""

    def __init__(self) -> None:
        super().__init__("date")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int32)


@dataclasses.dataclass(frozen=True)
class TimestampType(DataType):
    """Microseconds since the 1970-01-01 00:00:00 epoch, int64
    (reference spi/type/TimestampType: precision 6 short timestamp is
    an epoch-micros long the same way)."""

    def __init__(self) -> None:
        super().__init__("timestamp")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True)
class TimeType(DataType):
    """Microseconds since midnight, int64 (reference spi/type/TimeType)."""

    def __init__(self) -> None:
        super().__init__("time")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True)
class IntervalDayTimeType(DataType):
    """Day-to-second interval as microseconds, int64 (reference
    client IntervalDayTime millis; micros here to match TimestampType)."""

    def __init__(self) -> None:
        super().__init__("interval day to second")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True)
class IntervalYearMonthType(DataType):
    """Year-to-month interval as months, int32."""

    def __init__(self) -> None:
        super().__init__("interval year to month")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int32)


@dataclasses.dataclass(frozen=True)
class DecimalType(DataType):
    """Decimal as scaled integers (reference spi/type/DecimalType.java,
    Decimals.java:45): SHORT (precision <= 18) is one int64 per value;
    LONG (19..38) is int128 as TWO int64 limbs on a trailing axis
    ([n, 2]: low word's bit pattern, then the signed high word — see
    ops/int128.py for the vectorized limb arithmetic)."""

    precision: int = 38
    scale: int = 0

    def __init__(self, precision: int, scale: int) -> None:
        if precision > 38:
            raise ValueError(
                f"decimal({precision},{scale}): precision > 38")
        object.__setattr__(self, "precision", precision)
        object.__setattr__(self, "scale", scale)
        super().__init__(f"decimal({precision},{scale})")

    @property
    def is_long(self) -> bool:
        return self.precision > 18

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    @property
    def unscale_factor(self) -> int:
        return 10**self.scale


@dataclasses.dataclass(frozen=True)
class VarcharType(DataType):
    """Dictionary-encoded string. Physical value is an int32 code indexing
    the column's host-side dictionary; code -1 is reserved for padding."""

    length: int | None = None

    def __init__(self, length: int | None = None) -> None:
        object.__setattr__(self, "length", length)
        super().__init__("varchar" if length is None else f"varchar({length})")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int32)


@dataclasses.dataclass(frozen=True)
class UnknownType(DataType):
    """Type of NULL literals before coercion."""

    def __init__(self) -> None:
        super().__init__("unknown")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(np.int64)


@dataclasses.dataclass(frozen=True)
class ArrayType(DataType):
    """Variable-length array (reference spi/type/ArrayType). Values are
    host-side Python lists in an object ndarray — produced by
    host-finalized operators (array_agg); not a device dtype."""

    element: DataType = None  # type: ignore[assignment]

    def __init__(self, element: DataType) -> None:
        object.__setattr__(self, "element", element)
        super().__init__(f"array({element})")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(object)


@dataclasses.dataclass(frozen=True)
class MapType(DataType):
    """Key->value map (reference spi/type/MapType). Values are host-side
    Python dicts in an object ndarray; not a device dtype."""

    key: DataType = None  # type: ignore[assignment]
    value: DataType = None  # type: ignore[assignment]

    def __init__(self, key: DataType, value: DataType) -> None:
        object.__setattr__(self, "key", key)
        object.__setattr__(self, "value", value)
        super().__init__(f"map({key}, {value})")

    @property
    def physical_dtype(self) -> np.dtype:
        return np.dtype(object)


BIGINT = BigintType()
INTEGER = IntegerType()
DOUBLE = DoubleType()
BOOLEAN = BooleanType()
DATE = DateType()
TIMESTAMP = TimestampType()
TIME = TimeType()
INTERVAL_DAY_TIME = IntervalDayTimeType()
INTERVAL_YEAR_MONTH = IntervalYearMonthType()
VARCHAR = VarcharType()
UNKNOWN = UnknownType()

US_PER_SECOND = 1_000_000
US_PER_MINUTE = 60 * US_PER_SECOND
US_PER_HOUR = 60 * US_PER_MINUTE
US_PER_DAY = 24 * US_PER_HOUR


def is_numeric(t: DataType) -> bool:
    return isinstance(t, (BigintType, IntegerType, DoubleType, DecimalType))


def is_integer_like(t: DataType) -> bool:
    return isinstance(t, (BigintType, IntegerType))


def is_string(t: DataType) -> bool:
    return isinstance(t, VarcharType)


def common_super_type(a: DataType, b: DataType) -> DataType:
    """Implicit-coercion lattice, the analog of the reference's
    TypeCoercion (sql/analyzer/TypeCoercion.java)."""
    if a == b:
        return a
    if isinstance(a, UnknownType):
        return b
    if isinstance(b, UnknownType):
        return a
    # integer < bigint < decimal < double
    def rank(t: DataType) -> int | None:
        if isinstance(t, IntegerType):
            return 0
        if isinstance(t, BigintType):
            return 1
        if isinstance(t, DecimalType):
            return 2
        if isinstance(t, DoubleType):
            return 3
        return None

    ra, rb = rank(a), rank(b)
    if ra is not None and rb is not None:
        if ra < rb:
            a, b = b, a
            ra, rb = rb, ra
        if isinstance(a, DecimalType) and is_integer_like(b):
            # integer literals widen to decimal(x, 0)
            return DecimalType(18, a.scale)
        if isinstance(a, DecimalType) and isinstance(b, DecimalType):
            scale = max(a.scale, b.scale)
            return DecimalType(18, scale)
        return a
    if is_string(a) and is_string(b):
        return VARCHAR
    # date widens to timestamp (reference TypeCoercion DATE->TIMESTAMP)
    if {type(a), type(b)} == {DateType, TimestampType}:
        return TIMESTAMP
    raise TypeError(f"cannot unify types {a} and {b}")


def parse_type(s: str) -> DataType:
    """Inverse of str(DataType) — used by the plan/wire serde."""
    s = s.strip().lower()
    if s.startswith("decimal"):
        p, sc = s[s.index("(") + 1:s.rindex(")")].split(",")
        return DecimalType(int(p), int(sc))
    if s.startswith("varchar"):
        return VARCHAR
    if s.startswith("array(") and s.endswith(")"):
        return ArrayType(parse_type(s[6:-1]))
    if s.startswith("map(") and s.endswith(")"):
        inner = s[4:-1]
        # split on the top-level comma (element types may nest)
        depth = 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                return MapType(parse_type(inner[:i]),
                               parse_type(inner[i + 1:]))
        raise ValueError(f"cannot parse type {s!r}")
    simple = {"bigint": BIGINT, "integer": INTEGER, "double": DOUBLE,
              "boolean": BOOLEAN, "date": DATE, "unknown": UNKNOWN,
              "timestamp": TIMESTAMP, "time": TIME,
              "interval day to second": INTERVAL_DAY_TIME,
              "interval year to month": INTERVAL_YEAR_MONTH}
    if s in simple:
        return simple[s]
    raise ValueError(f"cannot parse type {s!r}")
