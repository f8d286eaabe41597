"""Committed-baseline store for the port's accepted analyzer findings, the
counterpart of ``src/repro/analysis/baseline.py``.

The baseline is a reviewed, committed JSON file
(``tools/lint_torch_baseline.json``) listing findings the repo explicitly
accepts, each with a justification. ``python tools/lint_torch.py`` exits
nonzero on any finding *not* in the baseline; ``--update-baseline``
rewrites the file from the current run (preserving justifications of
entries that survive) so every newly accepted finding is an explicit diff
in review.

Entries match on ``(rule, path, snippet)`` — the stripped source line, not
the line number — so unrelated edits that shift code do not invalidate the
baseline, while any edit to the offending line itself resurfaces the
finding for re-review. Matching is multiset-aware: two identical lines need
two entries.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import List, Sequence, Tuple

from repro_torch.analysis.detlint import Finding

__all__ = ["Baseline"]


@dataclasses.dataclass
class Baseline:
    entries: List[dict] = dataclasses.field(default_factory=lambda: [])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return cls(list(data.get("findings", [])))

    def save(self, path: str) -> None:
        payload = {
            "__comment__": (
                "Accepted static-analysis findings of the port (see docs/"
                "static-analysis-torch.md). Every entry needs a "
                "justification; regenerate with `python "
                "tools/lint_torch.py --update-baseline`."),
            "version": 1,
            "findings": self.entries,
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=False)
            f.write("\n")

    @staticmethod
    def _key(entry_or_finding) -> Tuple[str, str, str]:
        if isinstance(entry_or_finding, Finding):
            return entry_or_finding.fingerprint
        e = entry_or_finding
        return (e.get("rule", ""), e.get("path", ""), e.get("snippet", ""))

    def split(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """Partition ``findings`` into (new, accepted) and also return the
        baseline entries that matched nothing (stale — the code was fixed
        but the baseline kept the debt marker)."""
        budget = collections.Counter(self._key(e) for e in self.entries)
        new: List[Finding] = []
        accepted: List[Finding] = []
        for f in findings:
            if budget.get(f.fingerprint, 0) > 0:
                budget[f.fingerprint] -= 1
                accepted.append(f)
            else:
                new.append(f)
        stale = []
        for e in self.entries:
            k = self._key(e)
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                stale.append(e)
        return new, accepted, stale

    def rebuilt_from(self, findings: Sequence[Finding]) -> "Baseline":
        """A new baseline holding exactly ``findings``, carrying over the
        justification of any entry whose fingerprint survives."""
        just = {}
        for e in self.entries:
            just.setdefault(self._key(e), e.get("justification", ""))
        entries = []
        for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line)):
            entries.append({
                "rule": f.rule,
                "path": f.path,
                "snippet": f.snippet,
                "justification": just.get(f.fingerprint, "TODO: justify"),
            })
        return Baseline(entries)
