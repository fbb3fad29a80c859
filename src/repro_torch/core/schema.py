"""Table schemas for the device-resident relational cache (counterpart of
``repro.core.schema``).

A table is a fixed-capacity struct-of-arrays: scalar metadata *columns*
(int/float/bool; TEXT is interned host-side to int64 ids) plus optional
tensor *payloads* — one fixed-shape tensor per row, stored in a pool array
``[capacity, *shape]``. Payloads are the paper's "complex data without
serialization": typed device tensors (KV blocks, SSM states, encoder
outputs) instead of pickled blobs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

# SQL type name -> DECLARED numpy dtype (what validation and the planner
# read, exactly as in the reference). TEXT is an interned int32 id.
SQL_TYPES: dict[str, Any] = {
    "INT": np.int32,
    "INTEGER": np.int32,
    "BIGINT": np.int64,
    "FLOAT": np.float32,
    "REAL": np.float32,
    "DOUBLE": np.float64,
    "BOOL": np.bool_,
    "BOOLEAN": np.bool_,
    "TEXT": np.int32,  # interned string id (host-side interner; <2^31 ids)
}

# SQL type name -> the torch dtype a column is STORED in. The reference
# runs with 64-bit types off, so BIGINT stores int32 and DOUBLE float32
# there; the port keeps the same widths so large values agree.
STORAGE_DTYPES: dict[str, torch.dtype] = {
    "INT": torch.int32,
    "INTEGER": torch.int32,
    "BIGINT": torch.int32,
    "FLOAT": torch.float32,
    "REAL": torch.float32,
    "DOUBLE": torch.float32,
    "BOOL": torch.bool,
    "BOOLEAN": torch.bool,
    "TEXT": torch.int32,
}

# Columns maintained automatically on every table (the paper's expiry
# metadata): insertion timestamp, last access, per-row ttl (0 = no ttl).
RESERVED_COLUMNS = ("_created", "_accessed", "_ttl")


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    sql_type: str  # key into SQL_TYPES
    is_text: bool = False

    @property
    def declared(self):
        """The declared numpy dtype (validation / planner eligibility)."""
        return SQL_TYPES[self.sql_type.upper()]

    @property
    def dtype(self) -> torch.dtype:
        """The torch dtype the column is stored in."""
        return STORAGE_DTYPES[self.sql_type.upper()]


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """A fixed-shape tensor attached to each row (pool column)."""

    name: str
    shape: tuple[int, ...]
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class ExpiryPolicy:
    """The paper's three automatic expiry conditions (§4.3).

    - ``ttl``: default data-age limit in logical-clock ticks (0 = none);
      per-row ``_ttl`` overrides when nonzero.
    - ``max_rows``: table size cap; oldest rows evicted beyond it (0 = none).
    - ``ops_interval``: run automatic expiry every N cache operations
      (0 = only when explicitly asked).
    """

    ttl: int = 0
    max_rows: int = 0
    ops_interval: int = 0


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[ColumnSpec, ...]
    payloads: tuple[PayloadSpec, ...] = ()
    capacity: int = 4096
    max_select: int = 1024  # fixed upper bound on rows a SELECT returns
    expiry: ExpiryPolicy = ExpiryPolicy()
    # columns carrying a device-resident hash index (kernels/hashidx):
    # int32-typed only (INT, or TEXT via the interner). Equality lookups
    # on these lower to an O(1) bucket probe instead of a full scan.
    indexes: tuple[str, ...] = ()
    # Horizontal partitioning (core/shards.py): ``shards > 1`` hash-
    # partitions the rows across that many independent shard tables, each
    # with its own validity mask / relscan tiles / hash indexes, by a
    # multiplicative hash of ``partition_by`` (an int32 column — INT, or
    # TEXT via the interner; defaults to the first indexed column, else
    # the first int32 column). ``capacity`` stays the LOGICAL total; each
    # shard holds ceil(capacity / shards) rows. The shard count is NOT
    # fixed for the table's lifetime: ``ALTER TABLE t RESHARD n``
    # re-partitions live via ``dataclasses.replace(schema, shards=n)``
    # (this validation re-runs; ``partition_by`` survives a RESHARD 1
    # round trip so the table can be re-partitioned later).
    shards: int = 1
    partition_by: str | None = None
    # Cluster replication factor (``REPLICAS r``): metadata only at this
    # layer — the daemon stores and reports it, the cluster client
    # (core/cluster.py) mirrors writes to r ring-successor nodes.
    replicas: int = 1

    def __post_init__(self):
        names = [c.name for c in self.columns] + [p.name for p in self.payloads]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in table {self.name!r}")
        for r in RESERVED_COLUMNS:
            if r in names:
                raise ValueError(f"{r} is a reserved column name")
        if self.max_select > self.capacity:
            object.__setattr__(self, "max_select", self.capacity)
        for ix in self.indexes:
            if np.dtype(self.column(ix).declared) != np.int32:
                raise ValueError(
                    f"index on {ix!r}: only int32 (INT/TEXT) columns are "
                    f"indexable")
        if len(set(self.indexes)) != len(self.indexes):
            raise ValueError(f"duplicate index in table {self.name!r}")
        if self.shards < 1:
            raise ValueError(f"table {self.name!r}: SHARDS must be >= 1")
        if self.replicas < 1:
            raise ValueError(f"table {self.name!r}: REPLICAS must be >= 1")
        if self.shards > 1:
            if self.partition_by is None:
                object.__setattr__(self, "partition_by",
                                   self._default_partition_column())
            if np.dtype(self.column(self.partition_by).declared) != np.int32:
                raise ValueError(
                    f"PARTITION BY {self.partition_by!r}: only int32 "
                    f"(INT/TEXT) columns are partitionable")
        elif self.partition_by is not None:
            if not self.has_column(self.partition_by):
                raise KeyError(f"no column {self.partition_by!r} in table "
                               f"{self.name!r}")

    def _default_partition_column(self) -> str:
        if self.indexes:
            return self.indexes[0]
        for c in self.columns:
            if np.dtype(c.declared) == np.int32:
                return c.name
        raise ValueError(
            f"table {self.name!r}: SHARDS needs an int32 (INT/TEXT) column "
            f"to PARTITION BY")

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def column(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"no column {name!r} in table {self.name!r}")

    def payload(self, name: str) -> PayloadSpec:
        for p in self.payloads:
            if p.name == name:
                return p
        raise KeyError(f"no payload {name!r} in table {self.name!r}")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def text_columns(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns if c.is_text)


def validate_row_values(schema: TableSchema, values: Mapping[str, Any]) -> None:
    for k in values:
        if not schema.has_column(k):
            raise KeyError(f"unknown column {k!r} for table {schema.name!r}")


def make_schema(
    name: str,
    columns: Sequence[tuple[str, str]],
    payloads: Sequence[tuple[str, tuple[int, ...], Any]] = (),
    capacity: int = 4096,
    max_select: int = 1024,
    expiry: ExpiryPolicy = ExpiryPolicy(),
    indexes: Sequence[str] = (),
    shards: int = 1,
    partition_by: str | None = None,
    replicas: int = 1,
) -> TableSchema:
    cols = tuple(
        ColumnSpec(n, t, is_text=(t.upper() == "TEXT")) for n, t in columns
    )
    pls = tuple(PayloadSpec(n, tuple(s), d) for n, s, d in payloads)
    return TableSchema(name, cols, pls, capacity, max_select, expiry,
                       tuple(indexes), shards, partition_by, replicas)
