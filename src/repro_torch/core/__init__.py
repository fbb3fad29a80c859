"""Core of the port: the relational cache plane in PyTorch.

Public API:
    SQLCached      — the daemon (SQL in, device tensors out)
    TableSchema    — schema objects for direct (no-SQL) use
    make_schema    — schema constructor
    BatchScheduler — cross-connection admission queue / batch dispatcher
    StatementShape — shape_key() grouping descriptor for the scheduler
"""
from repro_torch.core.daemon import Result, SQLCached, StatementShape
from repro_torch.core.schema import ExpiryPolicy, TableSchema, make_schema
from repro_torch.core.scheduler import BatchScheduler

__all__ = [
    "SQLCached",
    "Result",
    "StatementShape",
    "BatchScheduler",
    "TableSchema",
    "ExpiryPolicy",
    "make_schema",
]
