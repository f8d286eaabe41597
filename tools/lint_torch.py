#!/usr/bin/env python
"""Determinism, numerics and launch static analysis of the PyTorch port.

Runs the three CPU layers of ``repro_torch.analysis`` over the port (the
counterpart of ``tools/lint.py``, with the same flags):

    python tools/lint_torch.py                    # all layers, exit 1 on findings
    python tools/lint_torch.py --ast-only         # fast AST pass only
    python tools/lint_torch.py --layers graph,launch
    python tools/lint_torch.py --update-baseline  # accept current findings
    python tools/lint_torch.py --paths src/repro_torch/core/urgency.py
    python tools/lint_torch.py -v                 # also show baselined/suppressed

Exit code 0 means no findings outside the committed baseline
(``tools/lint_torch_baseline.json``); stale baseline entries are reported
but informational. It imports torch and never JAX. The card's layer
(LCH000, LCH004) runs in ``chip_smoke.py``'s audit phase. See
docs/static-analysis-torch.md for the rule catalogue and workflow.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ("ast", "graph", "launch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="static analysis of the PyTorch port")
    parser.add_argument("--root", default=_REPO_ROOT,
                        help="repo root to lint (default: this repo)")
    parser.add_argument("--ast-only", action="store_true",
                        help="run only the AST layer")
    parser.add_argument("--layers", default=None,
                        help="comma-separated subset of ast,graph,launch")
    parser.add_argument("--paths", nargs="*", default=None,
                        help="repo-relative .py files for the AST layer "
                             "(default: src/repro_torch/ and "
                             "examples_torch/)")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: "
                             "<root>/tools/lint_torch_baseline.json)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from this run's findings")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print baselined and suppressed findings")
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root)
    # the graph and launch layers import the code they audit: the linted
    # tree's own src/ first (this repo's otherwise), so that
    # `python tools/lint_torch.py` needs no PYTHONPATH
    for src in (os.path.join(_REPO_ROOT, "src"), os.path.join(root, "src")):
        if os.path.isdir(os.path.join(src, "repro_torch", "analysis")):
            sys.path.insert(0, src)

    if args.layers:
        layers = tuple(x.strip() for x in args.layers.split(",") if x.strip())
    elif args.ast_only:
        layers = ("ast",)
    else:
        layers = LAYERS
    unknown = set(layers) - set(LAYERS)
    if unknown:
        parser.error(f"unknown layers: {sorted(unknown)}")

    from repro_torch.analysis.runner import run_suite

    report = run_suite(
        root,
        layers,
        paths=args.paths,
        baseline_path=args.baseline,
        update_baseline=args.update_baseline,
    )
    print(report.format(verbose=args.verbose))
    if args.update_baseline:
        print(f"baseline rewritten with {len(report.accepted)} entr"
              f"{'y' if len(report.accepted) == 1 else 'ies'}")
        return 0
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
