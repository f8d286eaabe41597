"""Suite runner: the port's three analysis layers behind one entry point
(the counterpart of ``src/repro/analysis/runner.py``).

``run_suite`` is what ``tools/lint_torch.py`` (and the "repo-is-clean"
test) calls: it runs the requested layers (``ast``, ``graph``, ``launch``),
subtracts the committed baseline, and renders a report whose exit code is
nonzero iff non-baselined findings remain. Baseline entries of a layer
that did not run (``card``: LCH000 and LCH004, which only the card's
audit phase in ``chip_smoke.py`` checks) are neither matched nor stale.
Tests inject polluted manifests and kernel specs to prove each layer
turns a seeded violation into a nonzero exit with file:line output.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.detlint import (
    DetlintConfig,
    Finding,
    default_config,
    lint_paths,
)

__all__ = ["SuiteReport", "run_suite", "DEFAULT_LAYERS", "layer_of",
           "BASELINE"]

DEFAULT_LAYERS = ("ast", "graph", "launch")
BASELINE = ("tools", "lint_torch_baseline.json")


def layer_of(rule: str) -> str:
    """The layer whose run can produce ``rule``."""
    if rule.startswith("DET"):
        return "ast"
    if rule.startswith("GRA"):
        return "graph"
    return "card" if rule in ("LCH000", "LCH004") else "launch"


@dataclasses.dataclass
class SuiteReport:
    findings: List[Finding]              # everything the layers produced
    new: List[Finding]                   # not covered by the baseline
    accepted: List[Finding]              # baselined
    stale_baseline: List[dict]           # baseline entries matching nothing
    suppressed: List[Finding]            # inline-suppressed (AST layer)
    layers: Tuple[str, ...]
    files_scanned: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.new else 0

    def format(self, verbose: bool = False) -> str:
        lines: List[str] = []
        for f in self.new:
            lines.append(f.format())
        if verbose:
            for f in self.accepted:
                lines.append(f"{f.format()}  [baselined]")
            for f in self.suppressed:
                lines.append(f"{f.format()}  [suppressed inline]")
        for e in self.stale_baseline:
            lines.append(
                f"{e.get('path')}: stale baseline entry "
                f"({e.get('rule')} {e.get('snippet')!r}) — the finding is "
                f"gone; run --update-baseline to drop it")
        lines.append(
            f"detlint: {self.files_scanned} files, layers "
            f"{'+'.join(self.layers)}: {len(self.new)} finding(s), "
            f"{len(self.accepted)} baselined, {len(self.suppressed)} "
            f"suppressed, {len(self.stale_baseline)} stale baseline "
            f"entr{'y' if len(self.stale_baseline) == 1 else 'ies'}")
        return "\n".join(lines)


def run_suite(
    root: str,
    layers: Sequence[str] = DEFAULT_LAYERS,
    *,
    paths: Optional[Sequence[str]] = None,
    config: Optional[DetlintConfig] = None,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    artifacts: Optional[Sequence] = None,
    recompile_guards: Optional[Sequence] = None,
    kernel_specs: Optional[Sequence] = None,
) -> SuiteReport:
    """Run the analysis layers over the port in the repo at ``root``.

    ``artifacts`` / ``recompile_guards`` / ``kernel_specs`` default to the
    precision manifest; tests inject synthetic ones. ``paths`` restricts
    the AST layer to specific repo-relative files. With
    ``update_baseline``, the baseline file is rewritten from this run's
    findings and the report treats everything as accepted.
    """
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    files_scanned = 0

    if "ast" in layers:
        if config is None:
            config = default_config()
        from repro_torch.analysis.detlint import iter_lint_files

        scan = list(paths) if paths is not None else list(
            iter_lint_files(root))
        files_scanned = len(scan)
        got, sup = lint_paths(root, scan, config)
        findings.extend(got)
        suppressed.extend(sup)

    if "graph" in layers:
        from repro_torch.analysis.graph_audit import (
            audit_precision_manifest,
            audit_recompile_guards,
        )

        findings.extend(
            _relativize(audit_precision_manifest(artifacts), root))
        findings.extend(
            _relativize(audit_recompile_guards(recompile_guards), root))

    if "launch" in layers:
        from repro_torch.analysis.launch_audit import audit_kernel_manifest

        findings.extend(_relativize(audit_kernel_manifest(kernel_specs),
                                    root))

    if baseline_path is None:
        baseline_path = os.path.join(root, *BASELINE)
    baseline = Baseline.load(baseline_path)
    ran = Baseline([e for e in baseline.entries
                    if layer_of(e.get("rule", "")) in layers])

    if update_baseline:
        kept = [e for e in baseline.entries if e not in ran.entries]
        Baseline(kept + ran.rebuilt_from(findings).entries).save(
            baseline_path)
        return SuiteReport(findings, [], findings, [], suppressed,
                           tuple(layers), files_scanned)

    new, accepted, stale = ran.split(findings)
    return SuiteReport(findings, new, accepted, stale, suppressed,
                       tuple(layers), files_scanned)


def _relativize(findings: List[Finding], root: str) -> List[Finding]:
    """Rewrite absolute artifact paths (from inspect) repo-relative so the
    report prints clickable repo paths."""
    root = os.path.abspath(root)
    out = []
    for f in findings:
        path = f.path
        if os.path.isabs(path):
            try:
                rel = os.path.relpath(path, root)
            except ValueError:
                rel = path
            if not rel.startswith(".."):
                path = rel.replace(os.sep, "/")
        out.append(dataclasses.replace(f, path=path))
    return out
