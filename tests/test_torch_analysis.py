"""The port's AST layer (``repro_torch.analysis.detlint``), its baseline,
its suite runner and ``tools/lint_torch.py``, held against the reference's
``repro.analysis``.

* Each DET rule's seeded case and clean twin from ``tests/test_analysis.py``
  runs through both ``repro.analysis.detlint.lint_source`` and the port's,
  with equivalent configs: both give the same ``(rule, line)`` list.
* The torch forms of DET001 (the global generator) and DET005 (narrow
  casts and dtype-less float factories in a float64 path) are flagged, and
  their seeded twins are clean.
* The baseline splits and rebuilds as the reference's does, and keeps a
  card-only entry out of a CPU run's stale list.
* The repo is clean under all three layers, and the CLI exits 0 on it and
  1 on a copy seeded with a torch global draw, a dtype-less factory in
  ``core/`` and a plan past a launch limit, naming each by path and line.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import detlint as ref_detlint
from repro_torch.analysis import detlint
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.detlint import DetlintConfig, Finding, lint_source
from repro_torch.analysis.runner import run_suite

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINT_CLI = os.path.join(REPO_ROOT, "tools", "lint_torch.py")

ENGINE = {"engine_modules": ("src/repro/core/sim.py",)}
ALLOW_TIMING = dict(ENGINE, timing_allowlist=(("src/repro/core/sim.py",
                                               "bench"),))
F64 = {"float64_paths": ("src/repro/core/",)}
ALLOW_F32 = dict(F64, float32_allowances=(("src/repro/core/x.py",
                                           "Fast.score"),))

# (id, source, path, config fields): the cases of tests/test_analysis.py
CASES = [
    ("det001-numpy-global", """
        import numpy as np
        VAL = np.random.rand(3)
     """, "src/sample.py", {}),
    ("det001-numpy-alias", """
        import numpy as xp
        xp.random.shuffle([1, 2])
     """, "src/sample.py", {}),
    ("det001-stdlib", """
        import random
        x = random.randint(0, 10)
     """, "src/sample.py", {}),
    ("det001-seeded-clean", """
        import numpy as np
        import random
        rng = np.random.default_rng(42)
        x = rng.normal(size=3)
        r = random.Random(7)
        y = r.randint(0, 10)
     """, "src/sample.py", {}),
    ("det001-suppressed", """
        import numpy as np
        VAL = np.random.rand(3)  # detlint: disable=DET001
     """, "src/sample.py", {}),
    ("det002-engine", """
        import time
        def step():
            return time.perf_counter()
     """, "src/repro/core/sim.py", ENGINE),
    ("det002-datetime", """
        import datetime
        def stamp():
            return datetime.datetime.now()
     """, "src/repro/core/sim.py", ENGINE),
    ("det002-outside-clean", """
        import time
        def step():
            return time.time()
     """, "src/repro/runtime/serve.py", ENGINE),
    ("det002-allowlisted-clean", """
        import time
        def bench():
            return time.perf_counter()
     """, "src/repro/core/sim.py", ALLOW_TIMING),
    ("det003-set-sum", """
        def total(items):
            seen = set(items)
            acc = 0.0
            for x in seen:
                acc += x
            return acc
     """, "src/sample.py", {}),
    ("det003-set-emission", """
        def emit(trace):
            for x in {1, 2, 3}:
                trace.append(x)
     """, "src/sample.py", {}),
    ("det003-sorted-clean", """
        def total(items):
            seen = set(items)
            acc = 0.0
            for x in sorted(seen):
                acc += x
            return acc
     """, "src/sample.py", {}),
    ("det003-dict-clean", """
        def total(d):
            acc = 0.0
            for k in d:
                acc += d[k]
            return acc
     """, "src/sample.py", {}),
    ("det004-list", """
        def f(acc=[]):
            acc.append(1)
            return acc
     """, "src/sample.py", {}),
    ("det004-factory", """
        def f(*, cache=dict()):
            return cache
     """, "src/sample.py", {}),
    ("det004-none-clean", """
        def f(acc=None):
            acc = [] if acc is None else acc
            return acc
     """, "src/sample.py", {}),
    ("det005-attribute", """
        import jax.numpy as jnp
        def score(w):
            return w.astype(jnp.float32).sum()
     """, "src/repro/core/x.py", F64),
    ("det005-dtype-string", """
        import numpy as np
        def score(w):
            return np.zeros(3, dtype="float32") + w.astype("f32")
     """, "src/repro/core/x.py", F64),
    ("det005-outside-clean", """
        import jax.numpy as jnp
        def score(w):
            return w.astype(jnp.float32).sum()
     """, "src/repro/kernels/x.py", F64),
    ("det005-allowance-clean", """
        import jax.numpy as jnp
        class Fast:
            def score(self, w):
                return w.astype(jnp.float32).sum()
     """, "src/repro/core/x.py", ALLOW_F32),
    ("det005-float64-clean", """
        import numpy as np
        def score(w):
            return w.astype(np.float64).sum()
     """, "src/repro/core/x.py", F64),
    ("det006-bare-except", """
        def f():
            try:
                return 1
            except:
                return 0
     """, "src/sample.py", {}),
    ("det006-is-literal", """
        def f(x):
            return x is 5
     """, "src/sample.py", {}),
    ("det006-is-none-clean", """
        def f(x):
            if x is None or x is True:
                return 0
            try:
                return 1
            except ValueError:
                return 0
     """, "src/sample.py", {}),
    ("det000-syntax", "def f(:\n    pass\n", "src/sample.py", {}),
]


def _rule_lines(findings):
    return [(f.rule, f.line) for f in findings]


@pytest.mark.parametrize("source,path,fields",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_same_findings_as_the_reference(source, path, fields):
    src = textwrap.dedent(source)
    want, want_sup = ref_detlint.lint_source(
        src, path, ref_detlint.DetlintConfig(**fields))
    got, got_sup = lint_source(src, path, DetlintConfig(**fields))
    assert _rule_lines(got) == _rule_lines(want)
    assert _rule_lines(got_sup) == _rule_lines(want_sup)


TORCH_F64 = DetlintConfig(float64_paths=("src/repro_torch/core/",))
CORE = "src/repro_torch/core/x.py"

# (id, line of code, path, expected rules)
TORCH_CASES = [
    ("rand", "x = torch.rand(3)", "src/m.py", ["DET001"]),
    ("randn-like", "x = torch.randn_like(y)", "src/m.py", ["DET001"]),
    ("randint", "x = torch.randint(0, 5, (3,))", "src/m.py", ["DET001"]),
    ("randperm", "x = torch.randperm(5)", "src/m.py", ["DET001"]),
    ("normal", "x = torch.normal(0.0, 1.0, (3,))", "src/m.py", ["DET001"]),
    ("bernoulli", "x = torch.bernoulli(p)", "src/m.py", ["DET001"]),
    ("multinomial", "x = torch.multinomial(p, 2)", "src/m.py", ["DET001"]),
    ("uniform-inplace", "w.uniform_(-1.0, 1.0)", "src/m.py", ["DET001"]),
    ("normal-inplace", "w[0].normal_()", "src/m.py", ["DET001"]),
    ("init-inplace", "torch.nn.init.normal_(w)", "src/m.py", ["DET001"]),
    ("exponential-inplace", "w.exponential_()", "src/m.py", ["DET001"]),
    ("manual-seed", "torch.manual_seed(0)", "src/m.py", ["DET001"]),
    ("rand-generator-clean", "x = torch.rand(3, generator=g)", "src/m.py",
     []),
    ("inplace-generator-clean", "w.uniform_(-1.0, 1.0, generator=g)",
     "src/m.py", []),
    ("generator-seed-clean", "g = torch.Generator().manual_seed(0)",
     "src/m.py", []),
    ("numpy-generator-clean", "x = rng.normal(size=3)", "src/m.py", []),
    ("float-cast", "y = x.float()", CORE, ["DET005"]),
    ("half-cast", "y = x.half()", CORE, ["DET005"]),
    ("bfloat16-cast", "y = x.bfloat16()", CORE, ["DET005"]),
    ("to-float32", "y = x.to(torch.float32)", CORE, ["DET005"]),
    ("zeros", "y = torch.zeros(3)", CORE, ["DET005"]),
    ("empty", "y = torch.empty((2, 3), device=d)", CORE, ["DET005"]),
    ("linspace", "y = torch.linspace(0, 1, 5)", CORE, ["DET005"]),
    ("tensor-float", "y = torch.tensor([1.0, 2.0])", CORE, ["DET005"]),
    ("full-float", "y = torch.full((2,), 0.5)", CORE, ["DET005"]),
    ("arange-float", "y = torch.arange(0.0, 1.0, 0.25)", CORE, ["DET005"]),
    ("as-tensor-float", "y = torch.as_tensor(-1.5)", CORE, ["DET005"]),
    ("zeros-dtype-clean", "y = torch.zeros(3, dtype=torch.float64)", CORE,
     []),
    ("tensor-int-clean", "y = torch.tensor([1, 2])", CORE, []),
    ("arange-int-clean", "y = torch.arange(5)", CORE, []),
    ("like-clean", "y = torch.zeros_like(x)", CORE, []),
    ("double-clean", "y = x.double()", CORE, []),
    ("builtin-float-clean", "y = float(x)", CORE, []),
    ("outside-f64-clean", "y = torch.zeros(3).float()", "src/m.py", []),
]


@pytest.mark.parametrize("line,path,rules", [c[1:] for c in TORCH_CASES],
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_forms(line, path, rules):
    got, _ = lint_source(f"import torch\n{line}\n", path, TORCH_F64)
    assert [f.rule for f in got] == rules
    assert all(f.line == 2 for f in got)


def test_torch_forms_honour_allowances_and_suppressions():
    cfg = DetlintConfig(float64_paths=("src/repro_torch/core/",),
                        float32_allowances=((CORE, "Fast"),))
    src = textwrap.dedent("""
        import torch
        class Fast:
            def score(self, w):
                return w.float() + torch.zeros(3)
        def seeded():
            return torch.rand(3)  # detlint: disable=DET001
    """)
    got, sup = lint_source(src, CORE, cfg)
    assert got == []
    assert [(f.rule, f.line) for f in sup] == [("DET001", 7)]


def test_default_scope_is_the_port():
    files = list(detlint.iter_lint_files(REPO_ROOT))
    assert files and all(f.startswith(("src/repro_torch/",
                                       "examples_torch/")) for f in files)
    assert "src/repro_torch/core/simfast.py" in files


class TestBaseline:
    F = Finding("DET001", "a.py", 3, "msg", snippet="torch.rand(3)")

    def entry(self, f, justification="known"):
        return {"rule": f.rule, "path": f.path, "snippet": f.snippet,
                "justification": justification}

    def test_split_new_accepted_stale(self):
        other = Finding("DET004", "b.py", 9, "msg", snippet="def f(a=[]):")
        base = Baseline([self.entry(self.F), self.entry(other)])
        new, accepted, stale = base.split([self.F])
        assert new == [] and accepted == [self.F]
        assert [e["path"] for e in stale] == ["b.py"]

    def test_multiset_matching(self):
        new, accepted, _ = Baseline([self.entry(self.F)]).split(
            [self.F, self.F])
        assert len(accepted) == 1 and len(new) == 1

    def test_rebuilt_preserves_justification(self, tmp_path):
        rebuilt = Baseline([self.entry(self.F, "reviewed")]).rebuilt_from(
            [self.F])
        assert rebuilt.entries[0]["justification"] == "reviewed"
        p = tmp_path / "baseline.json"
        rebuilt.save(str(p))
        assert Baseline.load(str(p)).entries == rebuilt.entries

    def test_card_entries_are_not_stale_on_the_cpu(self, tmp_path):
        p = tmp_path / "baseline.json"
        card = {"rule": "LCH004", "path": "src/x.cu", "snippet": "k::spill",
                "justification": "card only"}
        Baseline([card]).save(str(p))
        report = run_suite(REPO_ROOT, layers=("launch",),
                           baseline_path=str(p))
        assert report.exit_code == 0 and report.stale_baseline == []
        # updating the CPU layers' baseline keeps the card's entry
        run_suite(REPO_ROOT, layers=("launch",), baseline_path=str(p),
                  update_baseline=True)
        assert Baseline.load(str(p)).entries == [card]


def test_repo_is_clean():
    """All three layers over the port: no finding outside the committed
    baseline and no stale entry of a layer that ran."""
    report = run_suite(REPO_ROOT)
    assert report.new == [], report.format()
    assert report.stale_baseline == []
    assert report.files_scanned > 50


def _cli(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, LINT_CLI, *argv],
                          capture_output=True, text=True, env=env,
                          timeout=600)


def test_cli_repo_exits_zero():
    proc = _cli("--ast-only")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_cli_seeded_tree_exits_one(tmp_path):
    """A copy of the port seeded with a torch global draw, a dtype-less
    factory in core/ and an exit-head plan of 1056 threads a block."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO_ROOT, "src", "repro_torch"),
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(REPO_ROOT, "examples_torch"),
                    root / "examples_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "tools").mkdir()
    shutil.copy(os.path.join(REPO_ROOT, "tools", "lint_torch_baseline.json"),
                root / "tools")
    core = root / "src" / "repro_torch" / "core"
    (core / "jitter.py").write_text(
        "import torch\n\nJITTER = torch.rand(4)\n")
    urgency = core / "urgency.py"
    lines = urgency.read_text().splitlines()
    urgency.write_text("\n".join(lines + [
        "", "", "def _scratch(n):", "    return torch.zeros(n)", ""]))
    ops = root / "src" / "repro_torch" / "kernels" / "exit_head" / "ops.py"
    text = ops.read_text()
    assert "\nTHREADS = 256\n" in text
    ops.write_text(text.replace("\nTHREADS = 256\n", "\nTHREADS = 1056\n"))
    plan_line = next(i for i, ln in enumerate(text.splitlines(), 1)
                     if ln.startswith("def launch_plan("))

    proc = _cli("--root", str(root), "--layers", "ast,launch")
    out = proc.stdout
    assert proc.returncode == 1, out + proc.stderr
    assert "src/repro_torch/core/jitter.py:3: DET001" in out
    assert f"src/repro_torch/core/urgency.py:{len(lines) + 4}: DET005" in out
    assert (f"src/repro_torch/kernels/exit_head/ops.py:{plan_line}: LCH001"
            in out)


def test_cli_update_baseline_then_clean(tmp_path):
    root = tmp_path / "repo"
    (root / "src" / "repro_torch").mkdir(parents=True)
    (root / "src" / "repro_torch" / "app.py").write_text(
        "import torch\nVAL = torch.randn(3)\n")
    baseline = str(root / "baseline.json")
    args = ("--ast-only", "--root", str(root), "--baseline", baseline)
    assert _cli(*args).returncode == 1
    assert _cli(*args, "--update-baseline").returncode == 0
    proc = _cli(*args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    entries = json.load(open(baseline))["findings"]
    assert [e["rule"] for e in entries] == ["DET001"]
