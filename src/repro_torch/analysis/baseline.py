"""Committed-baseline support for the port's tentlint (`tentlint_torch_baseline.json`
at the root; an absent file is an empty baseline).

The baseline is a reviewed, committed JSON file that accepts specific
findings by *content fingerprint* rather than line number, so unrelated
edits above a baselined line don't invalidate the entry, while changing
the flagged code itself does (the fingerprint hashes the normalized line
text). Every entry carries a human `reason` — a baseline is a justified
debt record, not a mute button.

Format (version 1):

    {
      "version": 1,
      "findings": [
        {"rule": "...", "path": "...", "fingerprint": "...",
         "reason": "why this is accepted"}
      ]
    }

`--write-baseline` regenerates the file from the current active findings
(preserving reasons for fingerprints that survive); `--strict` fails on
stale entries so the debt record can only shrink by being paid down.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

from .core import Finding

__all__ = ["Baseline", "apply_baseline"]

_VERSION = 1


class Baseline:
    """The committed set of accepted findings, keyed by fingerprint."""

    def __init__(self, entries: Sequence[dict] = ()):  # validated dicts
        self.entries: List[dict] = list(entries)
        self.by_fp: Dict[str, dict] = {e["fingerprint"]: e
                                       for e in self.entries}

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        if data.get("version") != _VERSION:
            raise ValueError(
                f"{path}: unsupported baseline version {data.get('version')!r}"
                f" (expected {_VERSION})")
        entries = []
        for e in data.get("findings", []):
            missing = {"rule", "path", "fingerprint"} - set(e)
            if missing:
                raise ValueError(
                    f"{path}: baseline entry missing {sorted(missing)}: {e}")
            entries.append({
                "rule": e["rule"],
                "path": e["path"],
                "fingerprint": e["fingerprint"],
                "reason": e.get("reason", ""),
            })
        return cls(entries)

    def save(self, path: Path) -> None:
        payload = {
            "version": _VERSION,
            "findings": sorted(
                self.entries,
                key=lambda e: (e["path"], e["rule"], e["fingerprint"])),
        }
        path.write_text(json.dumps(payload, indent=2) + "\n")

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      old: "Baseline" = None,
                      default_reason: str = "accepted pre-existing finding"
                      ) -> "Baseline":
        """Build a baseline accepting every currently-active finding,
        carrying reasons forward from `old` where fingerprints survive."""
        entries = []
        seen: Set[str] = set()
        for f in findings:
            if f.suppressed or f.fingerprint in seen:
                continue
            seen.add(f.fingerprint)
            carried = old.by_fp.get(f.fingerprint) if old else None
            entries.append({
                "rule": f.rule,
                "path": f.path,
                "fingerprint": f.fingerprint,
                "reason": carried["reason"] if carried else default_reason,
            })
        return cls(entries)


def apply_baseline(findings: Sequence[Finding],
                   baseline: Baseline) -> Tuple[List[Finding], List[dict]]:
    """Mark findings whose fingerprints the baseline accepts; return the
    updated findings plus the *stale* baseline entries (accepted
    fingerprints that no longer occur — debt that has been paid and should
    be deleted from the file)."""
    matched: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        if f.fingerprint in baseline.by_fp and not f.suppressed:
            matched.add(f.fingerprint)
            out.append(Finding(**{**f.to_dict(), "baselined": True}))
        else:
            out.append(f)
    stale = [e for e in baseline.entries if e["fingerprint"] not in matched]
    return out, stale
