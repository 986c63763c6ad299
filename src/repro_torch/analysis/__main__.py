"""CLI driver: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean (modulo baseline), 1 new findings, 2 usage/self-test
failure. ``--write-baseline`` rewrites the baseline to the current
finding set (use after auditing that every remaining finding is
intentional). With no paths it analyzes the port: ``src/repro_torch``,
``tests/test_torch_*.py`` and ``chip_smoke.py`` under ``--root``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from repro_torch.analysis.core import (collect_files, run_analysis,
                                       run_rules, save_baseline)
from repro_torch.analysis.rules import RULE_DOCS, default_rules

BASELINE = "analysis_baseline_torch.json"
FIXTURE = Path(__file__).resolve().parent / "_fixtures" / "known_bad.py"


def default_paths(root: Path) -> List[Path]:
    """The port's sources: the package, its tests and the card smoke."""
    return [root / "src" / "repro_torch",
            *sorted((root / "tests").glob("test_torch_*.py")),
            root / "chip_smoke.py"]


def selftest() -> int:
    """Assert every rule fires on the known-bad fixture corpus."""
    if not FIXTURE.exists():
        print(f"selftest: fixture missing: {FIXTURE}", file=sys.stderr)
        return 2
    files = collect_files([FIXTURE], root=FIXTURE.parent, excludes=())
    findings = run_rules(files)
    fired = {f.rule for f in findings}
    expected = set(RULE_DOCS)
    for f in findings:
        print(f.render())
    missing = sorted(expected - fired)
    if missing:
        print(f"selftest FAILED: rules did not fire on known-bad fixture: "
              f"{', '.join(missing)}", file=sys.stderr)
        return 2
    print(f"selftest OK: all {len(expected)} rules fired "
          f"({len(findings)} findings on fixture)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch-aware repo-specific static analysis "
                    "(RA001-RA005) of the PyTorch port")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to analyze (default: "
                         "src/repro_torch tests/test_torch_*.py "
                         "chip_smoke.py)")
    ap.add_argument("--root", default=".",
                    help="repo root for relative paths and the baseline")
    ap.add_argument("--baseline", default=BASELINE,
                    help="baseline file, relative to --root")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run "
                         "(e.g. RA001,RA003)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the rules against the known-bad fixture "
                         "and assert every rule fires")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(RULE_DOCS):
            print(f"{code}  {RULE_DOCS[code]}")
        return 0
    if args.selftest:
        return selftest()

    root = Path(args.root).resolve()
    paths: List[Path] = []
    if not args.paths:
        paths = [p for p in default_paths(root) if p.exists()]
    for p in args.paths:
        cand = Path(p)
        if not cand.is_absolute():
            cand = root / cand
        if not cand.exists():
            print(f"warning: path does not exist, skipping: {p}",
                  file=sys.stderr)
            continue
        paths.append(cand)
    if not paths:
        print("error: no paths to analyze", file=sys.stderr)
        return 2

    select = ([s.strip().upper() for s in args.select.split(",")]
              if args.select else None)

    if args.write_baseline:
        files = collect_files(paths, root=root)
        rules = default_rules()
        if select:
            rules = [r for r in rules if r.code in set(select)]
        findings = run_rules(files, rules)
        save_baseline(root / args.baseline, findings)
        print(f"wrote {root / args.baseline}: {len(findings)} finding(s) "
              "baselined")
        return 0

    baseline_path = None if args.no_baseline else root / args.baseline
    new, stale, total = run_analysis(paths, root=root,
                                     baseline_path=baseline_path,
                                     select=select)
    for f in new:
        print(f.render())
    if stale:
        print(f"note: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (finding no longer "
              "present) — refresh with --write-baseline", file=sys.stderr)
    if new:
        print(f"\n{len(new)} new finding(s) ({total} total, "
              f"{total - len(new)} baselined). Fix, `# noqa: RAxxx` with "
              "a rationale, or re-baseline.", file=sys.stderr)
        return 1
    print(f"analysis clean: 0 new findings ({total} baselined)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
