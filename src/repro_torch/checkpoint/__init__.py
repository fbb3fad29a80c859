"""Checkpoint store of the port (``checkpoint/store.py``)."""
from repro_torch.checkpoint.store import (  # noqa: F401
    AsyncCheckpointer,
    host_copy,
    latest_step,
    restore,
    save,
)
