"""Findings, baselines, and rendering for the serving-stack analyzer.

A ``Finding`` is one rule violation at one source location.  Findings are
compared against a **committed baseline** so CI fails only on *new*
violations: a finding's identity is its ``fingerprint`` — (rule id,
repo-relative path, stripped source line) — deliberately *not* the line
number, so unrelated edits above a baselined violation don't resurrect it.
The baseline stores a count per fingerprint; the gate trips when any
fingerprint's live count exceeds its baselined count.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Tuple

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: machine-readable (rule id, file:line, severity)."""
    rule: str                          # e.g. "SYN001"
    path: str                          # repo-relative posix path
    line: int
    col: int
    severity: str                      # "error" | "warning"
    message: str
    snippet: str = ""                  # stripped source line (fingerprint key)

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        return f"{loc}: {self.severity} {self.rule}: {self.message}"


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


# ---------------------------------------------------------------------------
# baseline: committed fingerprint counts, CI fails only on NEW violations
# ---------------------------------------------------------------------------
def load_baseline(path: str) -> Counter:
    """Fingerprint -> allowed count.  A missing file is an empty baseline
    (every finding is new)."""
    if not path or not os.path.exists(path):
        return Counter()
    with open(path) as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"corrupt analysis baseline {path!r}: {e}. Fix the JSON by "
                "hand or regenerate it with "
                "`python -m repro_torch.analysis --update-baseline`.") from e
    base: Counter = Counter()
    for entry in data.get("findings", []):
        fp = (entry["rule"], entry["path"], entry.get("snippet", ""))
        base[fp] += int(entry.get("count", 1))
    return base


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    counts: Counter = Counter(f.fingerprint for f in findings)
    entries = [{"rule": r, "path": p, "snippet": s, "count": n}
               for (r, p, s), n in sorted(counts.items())]
    with open(path, "w") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=2)
        f.write("\n")


def new_findings(findings: Iterable[Finding], baseline: Counter
                 ) -> List[Finding]:
    """Findings beyond the baselined count per fingerprint — the only ones
    that fail the gate."""
    seen: Counter = Counter()
    out: List[Finding] = []
    for f in sort_findings(findings):
        seen[f.fingerprint] += 1
        if seen[f.fingerprint] > baseline.get(f.fingerprint, 0):
            out.append(f)
    return out


def to_json(findings: Iterable[Finding]) -> str:
    return json.dumps({"findings": [f.to_dict()
                                    for f in sort_findings(findings)]},
                      indent=2)
