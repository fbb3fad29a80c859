"""Project-specific configuration of the port's reprolint rules.

Everything a rule needs to know about the port — which modules form the
serving path, which functions on them are hot, which attribute names hold
device state, which bodies a CUDA graph captures, which calls hand back a
graph's own output buffer — lives here, so the rule implementations in
``rules.py`` stay generic AST analysis. The keys and the intent are the
reference's (``repro.lint.config``); the terms are torch's and CUDA's.

Module keys are the last two path components of a file
(``core/daemon.py``); the engine computes them in
``engine.ModuleContext``.
"""
from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# REP001 — device-sync-on-serving-path

# The serving modules: every statement a client sends flows through
# exactly these five files (wire -> scheduler -> daemon -> executor
# cache, with telemetry riding along), as in the reference.
SERVING_MODULES = frozenset({
    "core/daemon.py",
    "core/scheduler.py",
    "core/protocol.py",
    "core/telemetry.py",
    "core/execache.py",
})

# The hot functions inside them. REP001 checks these (and any function
# nested in them); everything else in a serving module is management
# plane (CREATE/RESHARD/CHECKPOINT/SHOW ...), where a host sync is the
# documented cost of the operation. ``Result`` / ``_HostStack``
# materialization is deliberately absent: lazy first-access sync IS the
# engine's one sanctioned device round-trip (render stage).
#
# The reference's list names five functions the port does not have; each
# is mapped to the port's counterpart or dropped:
#   daemon._do_insert        -> dropped: a single INSERT takes
#                               ``_do_insert_batch`` (listed)
#   daemon._jit_exec,
#   daemon._jit_with_expiry  -> ``_executor`` (listed) and ``_mesh_entry``:
#                               the executor-cache lookup, a mesh fan-out's
#                               entries included, replaces the jit wrappers
#   daemon._placement        -> ``_target`` (where a dispatch runs: the
#                               table's state, a lane, the blocks) and
#                               ``_lane_offset``
#   execache.preplanned      -> ``has_sig`` (the signature lookup that
#                               answers EXPLAIN's and the scheduler's
#                               "pre-planned?")
# and the port's executor cache adds its dispatch path: ``call_locked``
# (an entry's hit / miss), ``run`` and ``stage`` (a plan's staging, replay
# and output copy), ``acquire`` (the pinned staging ring), ``stage_array``.
SERVING_FUNCS: dict[str, frozenset] = {
    "core/daemon.py": frozenset({
        "execute", "execute_async", "executemany", "_dispatch_stmt",
        "_parse", "_table", "_intern_ast", "_prep_params", "_executor",
        "_mesh_entry", "_target", "_lane_offset", "_sig", "_note_sig",
        "_lane_of", "group_lane", "item_lanes", "_exec_mode",
        "_expire_flag", "_run_state", "_note_route", "_insert_sids",
        "_check_partition_update", "group_shard_ids", "_shard_ids_of",
        "_host_pval", "_insert_pvals", "group_warm", "_preplanned",
        "shape_key", "_shape_key_uncached", "_do_insert_batch",
        "_do_batch_dml", "_do_batch_select", "_do_batch_agg", "_do_select",
        "_do_update", "_do_delete",
    }),
    "core/scheduler.py": frozenset({
        "submit", "_plan", "_call_traced", "_run_single", "_locks_for",
        "_split_group", "_dispatch", "_dispatch_one", "_dispatch_inner",
        "_footprints_disjoint", "_compatible", "_is_cold",
        "_dispatch_wave", "_wait_for_arrivals", "_hold_window", "_loop",
    }),
    "core/protocol.py": frozenset({
        "_line", "_encode_arg", "_decode_arg", "_render_result",
        "_render_burst", "readline", "put_raw", "put_future", "_run",
        "_handle", "_mark_dropped",
    }),
    "core/telemetry.py": frozenset({
        "trace", "finish", "mark", "fold", "_fold_one", "_fold_loop",
        "record", "add", "max", "bulk", "bucket_of", "note_mode",
        "note_exec", "current_traces", "ring", "spans", "stage_totals",
    }),
    "core/execache.py": frozenset({
        "get", "__call__", "call_locked", "run", "stage", "acquire",
        "stage_array", "has_sig", "note_sig",
    }),
}

# Attribute names that hold device tensors (a table's state and its views,
# a Result's device outputs), read from the port's daemon: ``_Table.state``
# / ``lanes`` / ``blocks`` (``core/daemon.py`` ``_place``), ``Result._dev``
# and its ``*_device`` properties, ``Result.payloads``. An expression
# reaching one of these is treated as device-tainted.
DEVICE_ATTRS = frozenset({
    "state", "lanes", "blocks", "count_device", "row_ids_device",
    "present_device", "value_device", "payloads", "_dev",
})

# torch call chains that return HOST values (never device tensors) — not
# taint sources.
HOST_TORCH_CALLS = frozenset({
    "torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
    "torch.get_default_dtype", "torch.is_grad_enabled", "torch.no_grad",
    "torch.inference_mode", "torch.from_numpy",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
    "torch.cuda.Event", "torch.cuda.Stream", "torch.cuda.current_stream",
    "torch.cuda.stream", "torch.cuda.device",
    "torch.cuda.is_current_stream_capturing", "torch.cuda.graph_pool_handle",
})

# Sync sinks: calling one of these on (or with) a device-tainted value
# forces a device->host transfer or a blocking wait. ``.synchronize()``
# (``torch.cuda.synchronize()``, an event's, a stream's) always waits;
# ``.to("cpu")`` / ``.to(device="cpu")`` of a tainted value copies back.
SYNC_METHOD_ALWAYS = frozenset({"synchronize"})
SYNC_METHOD_TAINTED = frozenset({"item", "tolist", "cpu", "numpy"})
SYNC_CALL_ALWAYS = frozenset({"torch.cuda.synchronize"})
SYNC_FN_TAINTED = frozenset({"int", "float", "bool", "np.asarray",
                             "np.array", "numpy.asarray", "numpy.array"})
HOST_DEVICE_NAMES = frozenset({"cpu"})

# ---------------------------------------------------------------------------
# REP002 — bare shared-counter mutation outside telemetry.Counters
# (the reference's configuration: the rule is framework-free)

COUNTER_MODULES_PREFIX = "core/"
COUNTER_MODULES_EXEMPT = frozenset({"core/telemetry.py"})
COUNTER_NAME_RE = re.compile(r"(^|_)(stats|counters|counts)$")

# ---------------------------------------------------------------------------
# REP003 — lock acquisition outside the ordered helper (the reference's
# configuration)

LOCK_HELPER_FUNCS = frozenset({"_locks_for"})
MULTI_ACQUIRE_ALLOWED = frozenset({
    ("core/scheduler.py", "_dispatch_one"),
})
LOCK_MODULES_PREFIX = "core/"
LOCK_NAME_RE = re.compile(r"(^|_)r?locks?(_|$)", re.IGNORECASE)

# ---------------------------------------------------------------------------
# REP004 — host clock / randomness inside a captured body

# Calls that compile or capture the function handed to them as their first
# argument (a def by name, or a lambda) or that they decorate.
CAPTURE_WRAPPER_CHAINS = frozenset({
    "torch.cuda.make_graphed_callables", "torch.compile",
})
# ``with torch.cuda.graph(...)``: the block is captured.
CAPTURE_CONTEXT_CHAINS = frozenset({"torch.cuda.graph"})
# ``g.capture_begin()`` ... ``g.capture_end()``: what runs between them in
# one function is captured.
CAPTURE_BEGIN, CAPTURE_END = "capture_begin", "capture_end"
# Bodies that a capture runs by reference (module, function name): the
# statement plan's and the decode round's.
CAPTURED_BODIES = frozenset({
    ("core/execache.py", "_body"),
    ("serving/engine.py", "_body"),
})
HOST_NONDET_CHAINS = (
    "time.", "random.", "np.random.", "numpy.random.", "os.urandom",
    "uuid.", "secrets.", "datetime.now", "datetime.utcnow",
)

# ---------------------------------------------------------------------------
# REP005 — leftover prints on the serving path: the serving modules and
# the kernel wrappers

PRINT_MODULES = SERVING_MODULES | frozenset({
    "kernels/relscan.py", "kernels/hashidx.py", "kernels/ops.py",
    "kernels/flash_attention.py", "kernels/paged_attention.py",
    "kernels/mamba_scan.py",
})
PRINT_ALLOWED_FUNCS = frozenset({"main", "repl", "_main"})
# the reference's debug-print chains, kept so that a fixture shared with
# the reference's linter flags the same lines
PRINT_CHAINS = frozenset({"jax.debug.print", "pl.debug_print",
                          "debug.print"})

# ---------------------------------------------------------------------------
# REP006 — a read of a graph's raw output buffer after the entry ran again

# The port donates nothing. Its hazard of the same kind: a call with
# ``raw=True`` returns the plan's packed outputs uncopied — on the card
# the graph's own static buffer, which the entry's next replay
# overwrites. Method name -> the keyword that asks for the raw buffer.
RAW_CALLS: dict[str, str] = {"call_locked": "raw", "run": "raw"}
# (module, function) -> callee chains whose calls there return a raw
# buffer whatever their keywords say (``call_locked`` hands its own
# ``raw`` flag to ``plan.run`` by position).
RAW_SITES: dict[tuple, frozenset] = {
    ("core/execache.py", "call_locked"): frozenset({"plan.run"}),
}
