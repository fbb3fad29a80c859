"""Shared pytest fixtures. NOTE: do NOT set XLA_FLAGS device-count here —
smoke tests and benches must see the single real CPU device; only
launch/dryrun.py forces 512 placeholder devices (in its own process).
"""
import os

import numpy as np
import pytest

# CREATE TABLE spawns a background warm-up compile thread per table in
# production (REPRO_WARMUP=1 default). The suite creates hundreds of
# throwaway tables — default it off here; execache tests opt back in
# with SQLCached(warmup=True) / explicit WARMUP statements.
os.environ.setdefault("REPRO_WARMUP", "0")


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)


@pytest.fixture(scope="session", autouse=True)
def _lockcheck_no_cycles():
    """When the suite runs armed (REPRO_LOCKCHECK=1 in scripts/ci.sh),
    fail the session if the global acquisition-order graph picked up a
    cycle — a potential deadlock — even though no test hung."""
    yield
    from repro.lint import lockorder
    if lockorder.armed():
        cyc = lockorder.cycles()
        assert not cyc, (
            f"lock-order cycle(s) observed under REPRO_LOCKCHECK=1: {cyc} "
            f"(report: {lockorder.report()})")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with a reason) without one")
