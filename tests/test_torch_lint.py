"""The port's reprolint (``repro_torch.lint``): the counterpart of each
test of ``tests/test_lint.py`` (a true positive, a false-positive guard
and a pragma case for each of REP001-REP006 in the port's terms, the
baseline, the report, the CLI's exit codes, the rule docs, the live tree,
the lock-order sanitizer), the findings of the rules that know no
framework (REP002, REP003, REP005) held equal, by ID and line, to the
reference linter's on the same fixtures and on ``src/repro_torch``, and a
child process showing that importing the port's linter loads neither
``jax`` nor the JAX package.

Fixtures are tiny synthetic modules written under a ``core/``-shaped temp
directory so their ``module_key`` matches the config scopes
("core/daemon.py" etc.) without touching the real tree.
"""
import json
import subprocess
import sys
import textwrap
import threading

import pytest

from repro.lint import engine as ref_engine
from repro_torch.lint import engine, lockorder
from repro_torch.lint.rules import ALL_RULES


def lint(tmp_path, source, rel="core/daemon.py"):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return engine.run_lint([str(p)], use_baseline=False).findings


def unsilenced(findings, rule=None):
    return [f for f in findings
            if not f.suppressed and (rule is None or f.rule == rule)]


# ---------------------------------------------------------------------------
# REP001 — device sync on the serving path


def test_rep001_sync_in_serving_function(tmp_path):
    fs = lint(tmp_path, """\
        import torch

        def execute(self, x):
            y = torch.sum(x)
            torch.cuda.synchronize()
            n = int(torch.max(x))
            h = y.cpu()
            return n, y.to("cpu"), h
    """)
    hits = unsilenced(fs, "REP001")
    assert {f.line for f in hits} == {5, 6, 7, 8}
    assert len(hits) == 4


def test_rep001_taint_flows_through_locals(tmp_path):
    fs = lint(tmp_path, """\
        def execute(self):
            dev = self.t.state["cols"]
            host = np.asarray(dev)
            flag = bool(dev.any())
            return host, dev.sum().item(), flag
    """)
    assert {f.line for f in unsilenced(fs, "REP001")} == {3, 4, 5}


def test_rep001_ignores_management_plane_and_host_values(tmp_path):
    fs = lint(tmp_path, """\
        import torch

        def checkpoint(self, x):
            # not a serving function: sync is the documented cost here
            return float(torch.sum(x))

        def execute(self, k, ev):
            n = int(k)        # k is a host value, not device-tainted
            d = torch.cuda.device_count()   # host-returning torch call
            h = torch.from_numpy(k).item()  # a host tensor
            return n + d + h
    """)
    assert unsilenced(fs, "REP001") == []


def test_rep001_only_fires_in_serving_modules(tmp_path):
    fs = lint(tmp_path, """\
        import torch

        def execute(self, x):
            return float(torch.sum(x))
    """, rel="core/planner.py")
    assert unsilenced(fs, "REP001") == []


def test_rep001_pragma_suppresses_and_keeps_reason(tmp_path):
    fs = lint(tmp_path, """\
        import torch

        def execute(self, ev):
            # reprolint: disable=REP001(admin barrier, measured cold path)
            ev.synchronize()
    """)
    assert unsilenced(fs, "REP001") == []
    sup = [f for f in fs if f.rule == "REP001" and f.suppressed]
    assert len(sup) == 1
    assert "admin barrier" in sup[0].reason


# ---------------------------------------------------------------------------
# REP002 — bare shared-counter mutation


def test_rep002_augassign_and_spelled_out_rmw(tmp_path):
    fs = lint(tmp_path, """\
        def note(self, k):
            self.stats[k] += 1
            counts[k] = counts.get(k, 0) + 1
    """)
    assert len(unsilenced(fs, "REP002")) == 2


def test_rep002_plain_store_and_exempt_module(tmp_path):
    fs = lint(tmp_path, """\
        def snapshot(self, k, v):
            self.stats[k] = v          # overwrite, not read-modify-write
            self.rows[k] += 1          # not a counter-named map
    """)
    assert unsilenced(fs, "REP002") == []
    fs = lint(tmp_path, """\
        def add(self, k):
            self._counts[k] += 1
    """, rel="core/telemetry.py")
    assert unsilenced(fs, "REP002") == []


def test_rep002_pragma(tmp_path):
    fs = lint(tmp_path, """\
        def note(self, k):
            self.stats[k] += 1  # reprolint: disable=REP002(single-threaded REPL)
    """)
    assert unsilenced(fs, "REP002") == []


# ---------------------------------------------------------------------------
# REP003 — lock discipline


def test_rep003_nested_with_flagged(tmp_path):
    fs = lint(tmp_path, """\
        def swap(self):
            with self.lock_a:
                with self.lock_b:
                    pass
    """)
    hits = unsilenced(fs, "REP003")
    assert len(hits) == 1 and hits[0].line == 3


def test_rep003_inline_lock_ctor_in_scheduler(tmp_path):
    fs = lint(tmp_path, """\
        import asyncio

        def grab(self, table):
            return self._locks.setdefault(table, asyncio.Lock())

        def _locks_for(self, g):
            return [self._ent.setdefault("base", asyncio.Lock())]
    """, rel="core/scheduler.py")
    hits = unsilenced(fs, "REP003")
    assert len(hits) == 1 and hits[0].line == 4


def test_rep003_looped_acquire_flagged_but_dispatch_one_exempt(tmp_path):
    bad = """\
        async def hold(self, locks):
            for lk in locks:
                await lk.acquire()
    """
    fs = lint(tmp_path, bad, rel="core/scheduler.py")
    assert len(unsilenced(fs, "REP003")) == 1
    fs = lint(tmp_path, bad.replace("hold", "_dispatch_one"),
              rel="core/scheduler.py")
    assert unsilenced(fs, "REP003") == []


def test_rep003_single_lock_is_fine(tmp_path):
    fs = lint(tmp_path, """\
        def intern(self, s):
            with self._lock:
                return self._fwd[s]
    """)
    assert unsilenced(fs, "REP003") == []


# ---------------------------------------------------------------------------
# REP004 — host clock/random inside captured bodies


def test_rep004_captured_regions_and_bodies(tmp_path):
    fs = lint(tmp_path, """\
        import time, random, torch

        def capture(self, g, state):
            t0 = time.perf_counter()
            g.capture_begin()
            stamp = time.time()
            g.capture_end()
            return time.perf_counter() - t0, stamp

        def graphed(g, x):
            with torch.cuda.graph(g):
                y = x + random.random()
            return y

        def step(x):
            return x + time.monotonic()

        fast = torch.compile(step)

        @torch.compile
        def noisy(x):
            return x * np.random.rand()

        def _body(self, state, flag):
            return time.time_ns()
    """, rel="core/execache.py")
    assert {f.line for f in unsilenced(fs, "REP004")} == {6, 12, 16, 22,
                                                          25}


def test_rep004_host_side_clock_is_fine(tmp_path):
    fs = lint(tmp_path, """\
        import time

        def measure():
            return time.perf_counter()

        def _body(self):
            return time.time()   # not a declared body in this module
    """, rel="core/planner.py")
    assert unsilenced(fs, "REP004") == []


def test_rep004_pragma(tmp_path):
    fs = lint(tmp_path, """\
        import time, torch

        @torch.compile
        def step(s):
            # reprolint: disable=REP004(compile-time constant is intended)
            return s + time.time()
    """)
    assert unsilenced(fs, "REP004") == []


# ---------------------------------------------------------------------------
# REP005 — prints on the serving path


def test_rep005_print_flagged_exactly_once(tmp_path):
    fs = lint(tmp_path, """\
        def serve_loop(self):
            print("debug")
            jax.debug.print("x={}", 1)
    """)
    hits = unsilenced(fs, "REP005")
    assert [f.line for f in hits] == [2, 3]


def test_rep005_module_level_print_and_kernel_wrappers(tmp_path):
    fs = lint(tmp_path, """\
        FLAG = True
        if FLAG:
            print("import-time noise")
    """)
    assert len(unsilenced(fs, "REP005")) == 1
    fs = lint(tmp_path, """\
        def flash_attention(q, k, v):
            print(q.shape)
            return q
    """, rel="kernels/flash_attention.py")
    assert len(unsilenced(fs, "REP005")) == 1


def test_rep005_entrypoints_and_main_guard_allowed(tmp_path):
    fs = lint(tmp_path, """\
        def main():
            print("usage: ...")

        def repl():
            def inner():
                print("> ")
            inner()

        if __name__ == "__main__":
            print("banner")
    """)
    assert unsilenced(fs, "REP005") == []


def test_rep005_pragma(tmp_path):
    fs = lint(tmp_path, """\
        def serve_loop(self):
            # reprolint: disable=REP005(startup handshake parsed from stdout)
            print("READY")
    """)
    assert unsilenced(fs, "REP005") == []


def test_rep005_protocol_pragmas_keep_their_reasons():
    """The three handshake / banner prints of the port's wire server keep
    their pragmas and reasons."""
    path = engine.REPO_ROOT / "src" / "repro_torch" / "core" / "protocol.py"
    rep = engine.run_lint([str(path)], use_baseline=False)
    sup = [f for f in rep.findings if f.rule == "REP005" and f.suppressed]
    assert len(sup) == 3 and all(f.reason for f in sup)
    assert sum("handshake" in f.reason for f in sup) == 2


# ---------------------------------------------------------------------------
# REP006 — a graph's raw output read after its entry ran again


def test_rep006_raw_output_read_after_the_next_call(tmp_path):
    fs = lint(tmp_path, """\
        def serve(entry, other, state, args):
            plan, out = entry.call_locked(state, False, args, raw=True)
            other.call_locked(state, False, args)   # another entry: fine
            entry.call_locked(state, False, args)
            return out.clone()
    """)
    hits = unsilenced(fs, "REP006")
    assert len(hits) == 1 and hits[0].line == 5


def test_rep006_config_site_and_store_cleanse(tmp_path):
    fs = lint(tmp_path, """\
        def call_locked(self, plan, state, flag, leaves, raw):
            out = plan.run(state, flag, leaves, raw)
            plan.run(state, flag, leaves, raw)
            return out
    """, rel="core/execache.py")
    assert len(unsilenced(fs, "REP006")) == 1
    fs = lint(tmp_path, """\
        def call_locked(self, plan, state, flag, leaves, raw):
            out = plan.run(state, flag, leaves, raw)
            kept = out.clone()
            plan.run(state, flag, leaves, raw)
            out = kept
            return out
    """, rel="core/execache.py")
    assert unsilenced(fs, "REP006") == []


def test_rep006_no_raw_no_finding(tmp_path):
    fs = lint(tmp_path, """\
        def serve(entry, state, args):
            out = entry.call_locked(state, False, args)
            entry.call_locked(state, False, args)
            ran = [e.call_locked(state, False, args, raw=False)
                   for e in (entry,)]
            entry(state, False, args)
            return out, ran
    """)
    assert unsilenced(fs, "REP006") == []


def test_rep006_pragma(tmp_path):
    fs = lint(tmp_path, """\
        def serve(entry, state, args):
            out = entry.run(state, False, args, raw=True)
            entry(state, False, args)
            # reprolint: disable=REP006(the caller copied the bytes to the host first)
            return out
    """)
    assert unsilenced(fs, "REP006") == []


# ---------------------------------------------------------------------------
# engine: baseline round-trip, report, CLI


VIOLATION = """\
def serve_loop(self):
    print("legacy debug")
"""


def test_baseline_round_trip(tmp_path):
    src = tmp_path / "core" / "daemon.py"
    src.parent.mkdir(parents=True)
    src.write_text(VIOLATION)
    bl = tmp_path / "baseline.json"

    rep = engine.run_lint([str(src)], baseline_path=bl)
    assert len(rep.unsilenced) == 1

    n = engine.write_baseline(bl, rep.findings)
    assert n == 1 and json.loads(bl.read_text())[0]["rule"] == "REP005"

    rep = engine.run_lint([str(src)], baseline_path=bl)
    assert rep.unsilenced == [] and rep.findings[0].baselined

    src.write_text(VIOLATION + "    print('fresh')\n")
    rep = engine.run_lint([str(src)], baseline_path=bl)
    assert len(rep.unsilenced) == 1
    assert "fresh" in rep.unsilenced[0].snippet


def test_report_counts_and_json_shape(tmp_path):
    src = tmp_path / "core" / "daemon.py"
    src.parent.mkdir(parents=True)
    src.write_text(VIOLATION)
    rep = engine.run_lint([str(src)], use_baseline=False)
    d = rep.to_dict()
    assert d["counts"]["unsilenced"] == 1
    assert d["findings"][0]["rule"] == "REP005"
    assert "REP005" in rep.text()
    assert json.loads(engine.DEFAULT_BASELINE.read_text()) == []


def test_cli_exit_codes(tmp_path, capsys):
    from repro_torch.lint.__main__ import main
    src = tmp_path / "core" / "daemon.py"
    src.parent.mkdir(parents=True)
    src.write_text(VIOLATION)
    assert main([str(src), "--no-baseline", "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["counts"]["unsilenced"] == 1
    src.write_text("def serve_loop(self):\n    return 1\n")
    assert main([str(src), "--no-baseline"]) == 0
    capsys.readouterr()
    assert main(["--rules"]) == 0
    assert capsys.readouterr().out.count("REP00") == 6
    with pytest.raises(SystemExit) as e:
        main(["--no-such-flag"])
    assert e.value.code == 2
    bl = tmp_path / "bl.json"
    src.write_text(VIOLATION)
    assert main([str(src), "--write-baseline", "--baseline", str(bl)]) == 0
    assert main([str(src), "--baseline", str(bl)]) == 0


def test_live_tree_is_clean():
    """The shipping gate: ``python -m repro_torch.lint`` (its default path
    ``src/repro_torch``) has zero unsilenced findings, every pragma with a
    reason, and the CLI exits 0."""
    rep = engine.run_lint([str(engine.REPO_ROOT / "src" / "repro_torch")])
    assert rep.unsilenced == [], engine.LintReport(
        findings=rep.unsilenced, files=rep.files).text()
    for f in rep.findings:
        if f.suppressed:
            assert f.reason, f"pragma without a reason: {f.path}:{f.line}"
    from repro_torch.lint.__main__ import main
    assert main([]) == 0


def test_all_rules_documented():
    from repro_torch.lint.rules import RULE_DOCS
    assert sorted(RULE_DOCS) == [f"REP00{i}" for i in range(1, 7)]
    assert len(ALL_RULES) == 6
    from repro.lint.rules import RULE_DOCS as REF_DOCS
    for rid in ("REP001", "REP002", "REP003", "REP005"):
        assert RULE_DOCS[rid][0] == REF_DOCS[rid][0]


def test_config_names_exist_in_the_port():
    """Every serving function and device attribute the config names is
    defined in (or read by) the port's modules."""
    import ast

    from repro_torch.lint import config as C
    root = engine.REPO_ROOT / "src" / "repro_torch"
    for mod, names in C.SERVING_FUNCS.items():
        tree = ast.parse((root / mod).read_text())
        defs = {n.name for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert names <= defs, (mod, sorted(names - defs))
    daemon = (root / "core" / "daemon.py").read_text()
    for attr in C.DEVICE_ATTRS:
        assert f".{attr}" in daemon or f"def {attr}" in daemon, attr
    for mod, fn in C.CAPTURED_BODIES:
        assert f"def {fn}(" in (root / mod).read_text()


# ---------------------------------------------------------------------------
# the same findings as the reference linter where the rule knows no
# framework

SHARED = ("REP002", "REP003", "REP005")
SHARED_FIXTURES = [
    ("core/daemon.py", """\
        def note(self, k):
            self.stats[k] += 1
            counts[k] = counts.get(k, 0) + 1
            self.stats[k] += 1  # reprolint: disable=REP002(single-threaded)
            with self.lock_a:
                with self.lock_b:
                    print("nested")
    """),
    ("core/scheduler.py", """\
        import asyncio

        def grab(self, table):
            return self._locks.setdefault(table, asyncio.Lock())

        async def hold(self, locks):
            for lk in locks:
                await lk.acquire()

        def _locks_for(self, g):
            return [self._ent.setdefault("base", asyncio.Lock())]
    """),
    ("core/protocol.py", """\
        FLAG = True
        if FLAG:
            print("import-time noise")

        def main():
            print("usage")

        def serve_loop(self):
            # reprolint: disable=REP005(startup handshake)
            print("READY")
            jax.debug.print("x={}", 1)
    """),
]


def _by_rule(findings):
    return sorted((f.rule, f.line, f.suppressed) for f in findings
                  if f.rule in SHARED)


@pytest.mark.parametrize("rel,source", SHARED_FIXTURES,
                         ids=[r for r, _ in SHARED_FIXTURES])
def test_shared_rules_match_the_reference_on_fixtures(tmp_path, rel,
                                                      source):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    got = engine.run_lint([str(p)], use_baseline=False).findings
    want = ref_engine.run_lint([str(p)], use_baseline=False).findings
    assert _by_rule(got) == _by_rule(want) and _by_rule(got)


def test_shared_rules_match_the_reference_on_the_port():
    root = engine.REPO_ROOT / "src" / "repro_torch"
    got = engine.run_lint([str(root)], use_baseline=False).findings
    want = ref_engine.run_lint([str(root)], use_baseline=False).findings
    key = lambda fs: sorted((f.path, f.rule, f.line, f.suppressed)  # noqa
                            for f in fs if f.rule in SHARED)
    assert key(got) == key(want)
    assert any(f.rule == "REP005" for f in got)   # the protocol pragmas


def test_importing_the_linter_loads_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.lint as L; L.run_lint; L.lockorder; "
            "import repro_torch.lint.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); sys.exit(bool(bad))")
    env_path = str(engine.REPO_ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": env_path,
                                         "PATH": "/usr/bin:/bin"},
                         timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# lockorder — runtime sanitizer (the port's copy)


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


def test_lockorder_flags_two_thread_inversion():
    g = lockorder.Graph()
    a = lockorder.LockProxy("A", graph=g)
    b = lockorder.LockProxy("B", graph=g)

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    _in_thread(t1)
    _in_thread(t2)
    assert g.cycles() == [["A", "B"]]
    rep = g.report()
    assert rep["cycles"] and rep["locks"] == 2 and rep["acquisitions"] == 4


def test_lockorder_clean_on_consistent_order():
    g = lockorder.Graph()
    a = lockorder.LockProxy("A", graph=g)
    b = lockorder.LockProxy("B", graph=g)

    def worker():
        with a:
            with b:
                pass

    _in_thread(worker)
    _in_thread(worker)
    assert g.cycles() == []
    assert g.edges == {"A": {"B": 2}}


def test_lockorder_same_name_instances_merge():
    g = lockorder.Graph()
    l1 = lockorder.LockProxy("leaf", graph=g)
    l2 = lockorder.LockProxy("leaf", graph=g)
    with l1:
        with l2:
            pass
    assert g.edges == {} and g.cycles() == []


def test_lockorder_async_proxy_records_per_task():
    import asyncio

    g = lockorder.Graph()
    a = lockorder.AsyncLockProxy("base", graph=g)
    b = lockorder.AsyncLockProxy("lane0", graph=g)

    async def dispatch():
        await a.acquire()
        async with b:
            pass
        a.release()

    asyncio.run(dispatch())
    assert g.edges == {"base": {"lane0": 1}}
    assert g.cycles() == []


def test_lockorder_factories_respect_env(monkeypatch):
    monkeypatch.delenv("REPRO_LOCKCHECK", raising=False)
    assert not lockorder.armed()
    assert isinstance(lockorder.make_lock("x"), type(threading.Lock()))
    monkeypatch.setenv("REPRO_LOCKCHECK", "1")
    assert lockorder.armed()
    lk = lockorder.make_lock("x")
    assert isinstance(lk, lockorder.LockProxy)
    alk = lockorder.make_async_lock("y")
    assert isinstance(alk, lockorder.AsyncLockProxy)
    with lk:
        pass
    assert lockorder.summary()["armed"] is True


def test_show_stats_reports_lockcheck_field():
    from repro_torch.core.daemon import SQLCached

    db = SQLCached(device="cpu", warmup=False)
    db.execute("CREATE TABLE lkchk (k INT, v INT)")
    info = json.loads(db.execute("SHOW STATS").value)
    assert set(info["lockcheck"]) == {"armed", "edges", "cycles"}
    assert info["lockcheck"]["armed"] == lockorder.armed()
