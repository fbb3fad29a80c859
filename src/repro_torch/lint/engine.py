"""reprolint engine: file walking, pragmas, baseline, reporting (the
port's own copy of ``repro.lint.engine``: the port imports nothing of the
JAX package).

The engine is rule-agnostic: it parses each ``.py`` file once into an
:class:`ModuleContext` (AST + source lines + comment pragmas), hands the
context to every registered rule, then filters the returned findings
through line pragmas and the checked-in baseline.

Suppression layers (in order):

1. **pragmas** — ``# reprolint: disable=REP001(reason)`` on the finding
   line or the line directly above silences that rule there (several
   rules comma-separate; the parenthesised reason is optional but
   strongly encouraged — it is carried into the JSON report);
2. **baseline** — ``lint/baseline.json`` grandfathers pre-existing
   findings by (rule, path, normalized line text) so the linter can be
   turned on hard (exit 1 on anything new) without first fixing the
   world. ``python -m repro_torch.lint --write-baseline`` regenerates it.

Exit code contract: unsilenced findings => 1, clean => 0 (what the
port's live-tree test in ``tests/test_torch_lint.py`` gates on).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import pathlib
import re
import tokenize

__all__ = ["Finding", "LintReport", "ModuleContext", "run_lint",
           "DEFAULT_BASELINE"]

_PKG_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = _PKG_DIR.parents[2]          # src/repro_torch/lint -> repo root
DEFAULT_BASELINE = _PKG_DIR / "baseline.json"

_PRAGMA_RE = re.compile(r"#\s*reprolint:\s*disable=([^#]*)")
_PRAGMA_ITEM_RE = re.compile(r"(REP\d{3}|all)\s*(?:\(([^)]*)\))?")


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str           # repo-root-relative posix path when possible
    line: int
    col: int
    message: str
    snippet: str = ""
    suppressed: bool = False
    reason: str | None = None
    baselined: bool = False

    def norm_text(self) -> str:
        return " ".join(self.snippet.split())

    def key(self) -> tuple:
        return (self.rule, self.path, self.norm_text())

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "col": self.col, "message": self.message,
             "snippet": self.snippet.strip()}
        if self.suppressed:
            d["suppressed"] = True
            if self.reason:
                d["reason"] = self.reason
        if self.baselined:
            d["baselined"] = True
        return d


class ModuleContext:
    """Parsed view of one file, shared by every rule."""

    def __init__(self, path: pathlib.Path, source: str):
        self.abspath = path
        try:
            rel = path.resolve().relative_to(REPO_ROOT)
            self.path = rel.as_posix()
        except ValueError:
            self.path = path.as_posix()
        parts = pathlib.PurePosixPath(self.path).parts
        # config key: the last two components ("core/daemon.py")
        self.module_key = "/".join(parts[-2:]) if len(parts) >= 2 \
            else parts[-1]
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas = self._scan_pragmas(source)

    @staticmethod
    def _scan_pragmas(source: str) -> dict[int, dict[str, str | None]]:
        """line number -> {rule or "all": reason} from comment tokens."""
        out: dict[int, dict[str, str | None]] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if not m:
                    continue
                ent = out.setdefault(tok.start[0], {})
                for rule, reason in _PRAGMA_ITEM_RE.findall(m.group(1)):
                    ent[rule] = reason or None
        except tokenize.TokenError:
            pass
        return out

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def suppression(self, rule: str, line: int) -> tuple[bool, str | None]:
        """(suppressed, reason) for ``rule`` at ``line`` — pragma on the
        finding's own line or the line directly above."""
        for ln in (line, line - 1):
            ent = self.pragmas.get(ln)
            if not ent:
                continue
            if rule in ent:
                return True, ent[rule]
            if "all" in ent:
                return True, ent["all"]
        return False, None

    def make_finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        f = Finding(rule=rule, path=self.path, line=line, col=col,
                    message=message, snippet=self.snippet(line))
        f.suppressed, f.reason = self.suppression(rule, line)
        return f


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]
    files: int
    baseline_path: str | None = None

    @property
    def unsilenced(self) -> list[Finding]:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]

    def counts(self) -> dict:
        return {
            "total": len(self.findings),
            "unsilenced": len(self.unsilenced),
            "suppressed": sum(f.suppressed for f in self.findings),
            "baselined": sum(f.baselined for f in self.findings),
        }

    def to_dict(self) -> dict:
        return {"files": self.files, "counts": self.counts(),
                "findings": [f.to_dict() for f in self.findings]}

    def text(self) -> str:
        out = []
        for f in self.unsilenced:
            out.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
            snip = f.snippet.strip()
            if snip:
                out.append(f"    {snip}")
        c = self.counts()
        out.append(f"reprolint: {c['unsilenced']} finding(s) "
                   f"({c['suppressed']} pragma-suppressed, "
                   f"{c['baselined']} baselined) in {self.files} file(s)")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# baseline

def load_baseline(path: pathlib.Path) -> dict[tuple, int]:
    """{(rule, path, norm_text): allowed count}."""
    if not path.exists():
        return {}
    try:
        entries = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return {}
    out: dict[tuple, int] = {}
    for e in entries:
        k = (e.get("rule", ""), e.get("path", ""), e.get("text", ""))
        out[k] = out.get(k, 0) + int(e.get("count", 1))
    return out


def write_baseline(path: pathlib.Path, findings: list[Finding]) -> int:
    """Persist the still-unsilenced findings as the new baseline."""
    grouped: dict[tuple, dict] = {}
    for f in findings:
        if f.suppressed:
            continue
        k = f.key()
        ent = grouped.get(k)
        if ent is None:
            grouped[k] = {"rule": f.rule, "path": f.path,
                          "text": f.norm_text(), "line": f.line, "count": 1}
        else:
            ent["count"] += 1
    entries = sorted(grouped.values(),
                     key=lambda e: (e["path"], e["rule"], e["line"]))
    path.write_text(json.dumps(entries, indent=1) + "\n")
    return len(entries)


def apply_baseline(findings: list[Finding],
                   baseline: dict[tuple, int]) -> None:
    remaining = dict(baseline)
    for f in findings:
        if f.suppressed:
            continue
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            f.baselined = True


# ---------------------------------------------------------------------------
# the lint run

def _iter_py_files(paths) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def run_lint(paths, *, baseline_path=DEFAULT_BASELINE,
             use_baseline: bool = True, rules=None) -> LintReport:
    """Lint ``paths`` (files or directories) with every registered rule."""
    from repro_torch.lint.rules import ALL_RULES
    active = list(rules) if rules is not None else [r() for r in ALL_RULES]
    findings: list[Finding] = []
    files = 0
    for path in _iter_py_files(paths):
        try:
            source = path.read_text()
            ctx = ModuleContext(path, source)
        except (OSError, SyntaxError, UnicodeDecodeError):
            continue   # unparseable files are not lint findings
        files += 1
        for rule in active:
            findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    bp = pathlib.Path(baseline_path) if baseline_path else None
    if use_baseline and bp is not None:
        apply_baseline(findings, load_baseline(bp))
    return LintReport(findings=findings, files=files,
                      baseline_path=str(bp) if bp else None)
