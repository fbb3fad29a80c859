"""reprolint of the port — machine-checked serving-path invariants.

Two halves, as in the reference's ``repro.lint``:

* **static** (``python -m repro_torch.lint [paths] [--json]``, default
  path ``src/repro_torch``) — the port's own copy of the AST analysis
  engine (``engine.py``) with the reference's six rules in the port's
  terms (``rules.py``, configured in ``config.py``):

  ========  ==========================================================
  REP001    device sync (``.synchronize``/``.item``/``.tolist``/
            ``.cpu``/``.numpy``/``.to("cpu")``/``int()``/``float()``/
            ``bool()``/``np.asarray`` over a device value) inside a
            serving function of the five serving modules
  REP002    bare shared-counter read-modify-write (``stats[k] += 1``)
            outside ``telemetry.Counters``
  REP003    lock construction/acquisition bypassing the scheduler's
            ordered-acquisition helper (the lane-lock deadlock class)
  REP004    host clock / randomness inside a body a CUDA graph captures
            (or ``torch.compile`` compiles)
  REP005    leftover ``print`` in a serving module or a kernel wrapper
  REP006    a CUDA graph's raw output buffer read after its entry ran
            again (the port's counterpart of a use after donation)
  ========  ==========================================================

  Findings are suppressible per line with
  ``# reprolint: disable=REPnnn(reason)`` (same line or the line
  above; several rules comma-separate; the reason rides into the JSON
  report), or grandfathered wholesale in ``lint/baseline.json``
  (``--write-baseline`` regenerates it; it is empty).

* **dynamic** (``lint/lockorder.py``) — with ``REPRO_LOCKCHECK=1`` the
  daemon's and scheduler's locks become instrumented proxies that record
  the global acquisition-order graph and report any cycle.

Adding a rule: a class in ``rules.py`` (``ID``, ``TITLE``,
``check(ctx)``), its constants in ``config.py``, the class in
``ALL_RULES``, fixture tests in ``tests/test_torch_lint.py`` (a true
positive, a false-positive guard, a pragma case), and a clean
``python -m repro_torch.lint``.
"""
from __future__ import annotations

__all__ = ["run_lint", "Finding", "LintReport", "lockorder"]


def __getattr__(name):
    # lazy: core modules import repro_torch.lint.lockorder on their import
    # path; don't make them pay for the ast/tokenize machinery.
    # importlib (not `from ... import`): a from-import of a submodule
    # re-enters this hook through the fromlist check and recurses.
    import importlib
    if name in ("run_lint", "Finding", "LintReport"):
        engine = importlib.import_module("repro_torch.lint.engine")
        return getattr(engine, name)
    if name == "lockorder":
        return importlib.import_module("repro_torch.lint.lockorder")
    raise AttributeError(name)
