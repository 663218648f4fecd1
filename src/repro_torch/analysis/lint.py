"""The port's tentlint CLI: `python -m repro_torch.analysis.lint [paths...] [options]`.

Exit codes: 0 clean (every finding suppressed or baselined; under
`--strict` also no stale baseline entries and no parse errors), 1 active
findings (or strict-mode staleness), 2 usage errors.

Typical invocations:

    python -m repro_torch.analysis.lint                # the port's tree
    python -m repro_torch.analysis.lint --strict --json out.json   # the gate
    python -m repro_torch.analysis.lint src/repro_torch/csrc/tent_core.cu
    python -m repro_torch.analysis.lint --write-baseline   # accept current debt
    python -m repro_torch.analysis.lint --list-rules

The port's tree is its package (Python and CUDA sources), the tests, the
chip script and the kernel probe. The gate runs as a tier-1 test
(`tests/test_torch_analysis.py`) and as the chip script's `lint` phase.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from .baseline import Baseline, apply_baseline
from .core import Finding, Project, iter_source_files, run_rules
from .rules import ALL_RULES, default_rules

__all__ = ["main", "run_lint"]

DEFAULT_PATHS = ("src/repro_torch", "tests", "chip_smoke.py",
                 "kernel_probe.py")
DEFAULT_BASELINE = "tentlint_torch_baseline.json"


def find_root(start: Path) -> Path:
    """Walk up to the project root (pyproject.toml / .git marker)."""
    cur = start.resolve()
    for candidate in (cur, *cur.parents):
        if (candidate / "pyproject.toml").exists() or \
                (candidate / ".git").exists():
            return candidate
    return start


def run_lint(root: Path, paths: Sequence[Path], *,
             rules: Optional[Sequence[str]] = None,
             baseline_path: Optional[Path] = None):
    """Programmatic entry: returns (findings, stale_entries, project)."""
    files = iter_source_files(paths, root)
    project = Project(root, files)
    findings = run_rules(project, default_rules(rules))
    baseline = Baseline.load(baseline_path) if baseline_path else Baseline()
    findings, stale = apply_baseline(findings, baseline)
    return findings, stale, project


def _human_report(findings: List[Finding], stale: List[dict],
                  errors, strict: bool, out) -> None:
    active = [f for f in findings if f.active]
    for f in active:
        print(f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.message}",
              file=out)
        if f.snippet:
            print(f"    {f.snippet}", file=out)
    for rel, err in errors:
        print(f"{rel}: [parse-error] {err}", file=out)
    suppressed = sum(1 for f in findings if f.suppressed)
    baselined = sum(1 for f in findings if f.baselined)
    print(f"tentlint: {len(active)} active, {suppressed} suppressed, "
          f"{baselined} baselined, {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}, "
          f"{len(errors)} parse error{'' if len(errors) == 1 else 's'}",
          file=out)
    if stale and strict:
        for e in stale:
            print(f"  stale: [{e['rule']}] {e['path']} "
                  f"{e['fingerprint']} ({e.get('reason', '')}) — the "
                  "finding is gone; delete the entry", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="tentlint: enforce the port's determinism, parity, "
                    "contraction and hot-path invariants statically.")
    parser.add_argument("paths", nargs="*",
                        help=f"files/directories to lint "
                             f"(default: {' '.join(DEFAULT_PATHS)})")
    parser.add_argument("--root", type=Path, default=None,
                        help="project root (default: auto-detect via "
                             "pyproject.toml/.git walk-up)")
    parser.add_argument("--strict", action="store_true",
                        help="also fail on stale baseline entries and "
                             "parse errors (the CI gate)")
    parser.add_argument("--json", type=Path, metavar="FILE",
                        help="write the full machine-readable report")
    parser.add_argument("--baseline", type=Path, default=None,
                        help=f"baseline file (default: "
                             f"<root>/{DEFAULT_BASELINE})")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept all current active findings into the "
                             "baseline (reasons carried forward) and exit")
    parser.add_argument("--rules", type=str, default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:16s} {rule.description}")
        return 0

    root = args.root.resolve() if args.root else find_root(Path.cwd())
    baseline_path = args.baseline if args.baseline else \
        root / DEFAULT_BASELINE
    raw_paths = [Path(p) for p in args.paths] if args.paths else \
        [root / p for p in DEFAULT_PATHS if (root / p).exists()]
    rules = [r.strip() for r in args.rules.split(",") if r.strip()] \
        if args.rules else None

    try:
        findings, stale, project = run_lint(
            root, raw_paths, rules=rules, baseline_path=baseline_path)
    except ValueError as e:
        print(f"tentlint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        old = Baseline.load(baseline_path)
        new = Baseline.from_findings(
            [f for f in findings if not f.suppressed], old)
        new.save(baseline_path)
        print(f"tentlint: wrote {len(new.entries)} baseline entr"
              f"{'y' if len(new.entries) == 1 else 'ies'} to "
              f"{baseline_path}")
        return 0

    if args.json:
        report = {
            "root": str(root),
            "files_scanned": len(project.contexts),
            "findings": [f.to_dict() for f in findings],
            "stale_baseline": stale,
            "parse_errors": [{"path": p, "error": e}
                             for p, e in project.errors],
            "counts": {
                "active": sum(1 for f in findings if f.active),
                "suppressed": sum(1 for f in findings if f.suppressed),
                "baselined": sum(1 for f in findings if f.baselined),
                "files_scanned": project.files_by_suffix(),
            },
        }
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=2) + "\n")

    _human_report(findings, stale, project.errors, args.strict, sys.stdout)

    active = any(f.active for f in findings)
    strict_fail = args.strict and (stale or project.errors)
    return 1 if (active or strict_fail) else 0


if __name__ == "__main__":
    raise SystemExit(main())
