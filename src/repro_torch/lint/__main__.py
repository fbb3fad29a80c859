"""CLI: ``python -m repro_torch.lint [paths...] [--json] [--write-baseline]
[--no-baseline] [--rules]``.

Exit code 0 = no unsilenced findings, 1 = findings, 2 = usage error (the
reference's contract). The default path is ``src/repro_torch`` relative to
the repo root: the port's rules are written for the port, not for the JAX
package (whose own linter is ``python -m repro.lint``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.lint import engine
from repro_torch.lint.rules import RULE_DOCS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="reprolint: the port's serving-path invariant linter")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the full report as JSON")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate lint/baseline.json from the current "
                         "unsilenced findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the checked-in baseline")
    ap.add_argument("--baseline", default=None,
                    help="alternate baseline file")
    ap.add_argument("--rules", action="store_true",
                    help="list the rules and exit")
    args = ap.parse_args(argv)

    if args.rules:
        for rid, (title, _) in sorted(RULE_DOCS.items()):
            print(f"{rid}  {title}")
        return 0

    paths = args.paths or [str(engine.REPO_ROOT / "src" / "repro_torch")]
    baseline = pathlib.Path(args.baseline) if args.baseline \
        else engine.DEFAULT_BASELINE

    if args.write_baseline:
        rep = engine.run_lint(paths, baseline_path=baseline,
                              use_baseline=False)
        n = engine.write_baseline(baseline, rep.findings)
        print(f"reprolint: wrote {n} baseline entr"
              f"{'y' if n == 1 else 'ies'} to {baseline}")
        return 0

    rep = engine.run_lint(paths, baseline_path=baseline,
                          use_baseline=not args.no_baseline)
    if args.as_json:
        print(json.dumps(rep.to_dict(), indent=1, sort_keys=True))
    else:
        print(rep.text())
    return 1 if rep.unsilenced else 0


if __name__ == "__main__":
    sys.exit(main())
