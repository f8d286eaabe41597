"""Determinism, numerics and launch static analysis for the port (the
counterpart of ``src/repro/analysis``).

The port's guarantees (the scan tiers bitwise equal to the Python engines,
the goldens at rtol 1e-9, a kernel that launches at every served shape)
rest on disciplines that tests only catch after a violation ships. This
package enforces them statically, in three layers:

  * :mod:`repro_torch.analysis.detlint`      - AST rules DET001-DET006
    over ``src/repro_torch/`` and ``examples_torch/`` (with torch's global
    generator and default float type), inline suppressions and a committed
    baseline;
  * :mod:`repro_torch.analysis.graph_audit`  - traces the manifest's
    artifacts to aten graphs with ``make_fx`` under fake tensors: dtype
    contracts, a host-sync denylist, and no-rebuild guards on the graph
    caches;
  * :mod:`repro_torch.analysis.launch_audit` - each CUDA kernel's launch
    plan at its envelopes: grid and block limits, coverage and 32-bit
    indexing, shared memory; on the card the C plans against the Python
    ones and ptxas's registers and spills.

``python tools/lint_torch.py`` runs the CPU layers; ``chip_smoke.py``'s
audit phase the card's. docs/static-analysis-torch.md has the rule
catalogue and the baseline workflow.
"""

from repro_torch.analysis.detlint import (  # noqa: F401
    DetlintConfig,
    Finding,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.baseline import Baseline  # noqa: F401
from repro_torch.analysis.graph_audit import (  # noqa: F401
    audit_artifact,
    audit_graph,
    no_recompile_findings,
)
from repro_torch.analysis.launch_audit import (  # noqa: F401
    audit_kernel,
    audit_launch,
)
from repro_torch.analysis.runner import run_suite  # noqa: F401

__all__ = [
    "Baseline",
    "DetlintConfig",
    "Finding",
    "audit_artifact",
    "audit_graph",
    "audit_kernel",
    "audit_launch",
    "lint_paths",
    "lint_source",
    "no_recompile_findings",
    "run_suite",
]
