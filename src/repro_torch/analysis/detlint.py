"""detlint for the port: the AST rules of the determinism contract (the
first layer), the counterpart of ``src/repro/analysis/detlint.py``.

The same six rules, with the same ``Finding``, suppression comment and
baseline, over ``src/repro_torch/`` and ``examples_torch/``; where torch
has its own form of a rule's hazard, the rule covers it too
(docs/static-analysis-torch.md has the catalogue):

  DET001  unseeded global RNG: numpy's legacy ``np.random.*`` and stdlib
          ``random.*`` module functions, and torch's global generator:
          ``torch.rand*``, ``randn*``, ``randint*``, ``randperm``,
          ``normal``, ``bernoulli`` and ``multinomial`` without
          ``generator=``, the in-place ``uniform_``, ``normal_``,
          ``random_`` and ``exponential_`` without ``generator=``, and
          ``torch.manual_seed`` (which seeds state shared by every caller);
          use a seeded ``torch.Generator`` or ``np.random.default_rng``.
  DET002  wall-clock reads inside engine modules.
  DET003  iteration over a ``set`` feeding accumulation or emission.
  DET004  mutable default arguments.
  DET005  float32/float16/bfloat16 in declared float64 paths: literals,
          dtype strings, ``torch.float32``-style attributes (so
          ``.to(torch.float32)``), the casts ``.float()``, ``.half()`` and
          ``.bfloat16()``, and a float tensor factory without ``dtype=``
          (torch's default float type is float32, where JAX under x64
          defaults to float64): ``torch.zeros``, ``ones``, ``empty`` and
          ``linspace`` always, ``torch.tensor``, ``as_tensor``, ``full``
          and ``arange`` given a float argument. ``*_like`` factories take
          their input's dtype and are not flagged.
  DET006  bare ``except:`` and ``is`` comparisons against literals.

Suppression: append ``# detlint: disable=DET0xx`` (comma-separated list)
to the offending line. Accepted findings live in the committed baseline
(:mod:`repro_torch.analysis.baseline`).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, List, Optional, Sequence, Tuple

__all__ = ["Finding", "DetlintConfig", "RULES", "lint_source", "lint_paths",
           "default_config", "iter_lint_files"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding, shared by all three layers.

    ``snippet`` is the stripped source line (or artifact detail for the
    graph and launch layers): baselines match on ``(rule, path, snippet)`` so
    unrelated edits that shift line numbers do not invalidate them.
    """

    rule: str
    path: str
    line: int
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


RULES = {
    "DET001": "unseeded module-level RNG",
    "DET002": "wall-clock read in engine module",
    "DET003": "set iteration feeding accumulation/emission",
    "DET004": "mutable default argument",
    "DET005": "float32 in declared float64 path",
    "DET006": "bare except / 'is' on literal",
}


@dataclasses.dataclass(frozen=True)
class DetlintConfig:
    """Rule scoping (defaults come from the precision manifest).

    ``engine_modules``: repo-relative paths DET002 applies to.
    ``timing_allowlist``: ``(path, qualname)`` pairs where a wall-clock
        read is an explicit, documented timing context.
    ``float64_paths``: repo-relative prefixes under the float64 contract
        (DET005 scope).
    ``float32_allowances``: ``(path, qualname-prefix)`` pairs naming the
        declared float32 tier inside a float64 path (each carries a
        justification in the manifest).
    """

    engine_modules: Tuple[str, ...] = ()
    timing_allowlist: Tuple[Tuple[str, str], ...] = ()
    float64_paths: Tuple[str, ...] = ()
    float32_allowances: Tuple[Tuple[str, str], ...] = ()


def default_config() -> DetlintConfig:
    from repro_torch.analysis import manifest

    return DetlintConfig(
        engine_modules=manifest.ENGINE_MODULES,
        timing_allowlist=tuple(
            (a.path, a.scope) for a in manifest.TIMING_ALLOWLIST),
        float64_paths=manifest.FLOAT64_PATHS,
        float32_allowances=tuple(
            (a.path, a.scope) for a in manifest.FLOAT32_ALLOWANCES),
    )


# -- rule data ---------------------------------------------------------------

# numpy legacy global-state API (np.random.<fn>). The Generator API
# (default_rng / Generator / SeedSequence / PCG64) is the seeded replacement
# and is never flagged.
_NP_GLOBAL_RNG = frozenset({
    "seed", "rand", "randn", "random", "random_sample", "ranf", "sample",
    "randint", "random_integers", "choice", "bytes", "shuffle", "permutation",
    "uniform", "normal", "standard_normal", "exponential", "poisson",
    "binomial", "beta", "gamma", "lognormal", "laplace", "pareto",
    "get_state", "set_state",
})

# stdlib random module-level functions (the hidden global Random instance).
# random.Random(seed) / SystemRandom are explicit instances and not flagged.
_STDLIB_RNG = frozenset({
    "seed", "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "gammavariate", "triangular",
    "vonmisesvariate", "paretovariate", "weibullvariate", "getrandbits",
    "randbytes", "getstate", "setstate",
})

_WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns", "time.process_time",
    "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

# torch's global-generator draws: flagged without ``generator=``
_TORCH_RNG = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial",
})
_TORCH_RNG_INPLACE = frozenset({"uniform_", "normal_", "random_",
                                "exponential_"})
_TORCH_SEED = frozenset({"torch.manual_seed", "torch.random.manual_seed",
                         "torch.cuda.manual_seed",
                         "torch.cuda.manual_seed_all"})
# torch factories whose default dtype is the default float type (float32):
# always float, or float when given a float argument
_TORCH_FLOAT_FACTORIES = frozenset({"zeros", "ones", "empty", "linspace"})
_TORCH_VALUE_FACTORIES = frozenset({"tensor", "as_tensor", "full", "arange"})
_F32_CASTS = frozenset({"float", "half", "bfloat16"})

_F32_ATTRS = frozenset({"float32", "float16", "bfloat16"})
_F32_STRINGS = frozenset({"float32", "float16", "bfloat16", "f32", "f16",
                          "bf16"})
_MUTABLE_FACTORIES = frozenset({"list", "dict", "set", "defaultdict", "deque",
                                "Counter", "OrderedDict"})
_EMIT_METHODS = frozenset({"append", "extend", "add", "record", "emit",
                           "write", "put"})

_SUPPRESS_RE = re.compile(r"#\s*detlint:\s*disable=([A-Z0-9,\s]+)")


def _suppressions(source: str) -> dict:
    """line number -> set of rule ids suppressed on that line."""
    out = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, lines: Sequence[str], config: DetlintConfig):
        self.path = path
        self.lines = lines
        self.config = config
        self.findings: List[Finding] = []
        self.scope: List[str] = []          # qualname stack
        self.set_names: List[set] = [set()]  # per-scope names bound to sets
        # import alias maps: local name -> canonical dotted module
        self.modules: dict = {}
        # names imported directly from `random` / `time` / `datetime`
        self.from_funcs: dict = {}

        self.in_f64_path = any(
            path.startswith(p) for p in config.float64_paths)
        self.is_engine = path in set(config.engine_modules)

    # -- helpers ------------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 1)
        snippet = ""
        if 1 <= line <= len(self.lines):
            snippet = self.lines[line - 1].strip()
        self.findings.append(Finding(rule, self.path, line, message, snippet))

    def _qualname(self) -> str:
        return ".".join(self.scope)

    def _dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve an attribute chain to a canonical dotted name, mapping
        import aliases (``np`` -> ``numpy``) at the root."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            root = node.id
            canon = self.modules.get(root)
            if canon is None and root in self.from_funcs:
                canon = self.from_funcs[root]
                if parts:
                    return canon + "." + ".".join(reversed(parts))
                return canon
            parts.append(canon if canon is not None else root)
            return ".".join(reversed(parts))
        return None

    def _allowed_f32(self) -> bool:
        qn = self._qualname()
        for path, scope in self.config.float32_allowances:
            if path == self.path and (qn == scope or
                                      qn.startswith(scope + ".")):
                return True
        return False

    def _allowed_timing(self) -> bool:
        qn = self._qualname()
        for path, scope in self.config.timing_allowlist:
            if path == self.path and (qn == scope or
                                      qn.startswith(scope + ".")):
                return True
        return False

    # -- imports ------------------------------------------------------------

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self.modules[alias.asname or alias.name.split(".")[0]] = (
                alias.name if alias.asname else alias.name.split(".")[0])
            if alias.asname:
                self.modules[alias.asname] = alias.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module is None:
            return
        for alias in node.names:
            local = alias.asname or alias.name
            full = f"{node.module}.{alias.name}"
            # `from numpy import random` binds a module; `from random import
            # randint` binds a function. Both resolve through one map.
            if alias.name in ("random",) and node.module in ("numpy",
                                                             "torch"):
                self.modules[local] = full
            elif node.module in ("random", "time", "datetime"):
                self.from_funcs[local] = full
        self.generic_visit(node)

    # -- scope tracking ------------------------------------------------------

    def _visit_scoped(self, node, name: str):
        self.scope.append(name)
        self.set_names.append(set())
        self.generic_visit(node)
        self.set_names.pop()
        self.scope.pop()

    def visit_ClassDef(self, node):
        self._visit_scoped(node, node.name)

    def visit_FunctionDef(self, node):
        self._check_det004(node)
        self._visit_scoped(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._check_det004(node)
        self._visit_scoped(node, node.name)

    # -- DET004 --------------------------------------------------------------

    def _check_det004(self, node):
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(
                d, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp))
            if (isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                    and d.func.id in _MUTABLE_FACTORIES):
                mutable = True
            if mutable:
                self._emit(
                    "DET004", d,
                    f"mutable default argument in {node.name}() is shared "
                    f"across calls; default to None and create inside",
                )

    # -- DET001 / DET002 (calls) ---------------------------------------------

    def visit_Call(self, node: ast.Call):
        dotted = self._dotted(node.func)
        if dotted:
            self._check_rng(node, dotted)
            self._check_torch_rng(node, dotted)
            self._check_clock(node, dotted)
            if self.in_f64_path and not self._allowed_f32():
                self._check_factory(node, dotted)
        elif isinstance(node.func, ast.Attribute):
            self._check_inplace_rng(node, node.func.attr)
        if (isinstance(node.func, ast.Attribute) and self.in_f64_path
                and node.func.attr in ("float", "half") and not node.args
                and not node.keywords and not self._allowed_f32()):
            self._emit(
                "DET005", node,
                f".{node.func.attr}() casts to a narrow float in a "
                f"declared float64 scheduling path",
            )
        self.generic_visit(node)

    @staticmethod
    def _has_generator(node: ast.Call) -> bool:
        return any(kw.arg == "generator" for kw in node.keywords)

    def _check_torch_rng(self, node, dotted: str):
        parts = dotted.split(".")
        if dotted in _TORCH_SEED:
            self._emit(
                "DET001", node,
                f"{dotted}() seeds torch's global generator, shared by "
                f"every caller; seed a torch.Generator and pass it",
            )
        elif (len(parts) == 2 and parts[0] == "torch"
              and parts[1] in _TORCH_RNG and not self._has_generator(node)):
            self._emit(
                "DET001", node,
                f"{dotted}() draws from torch's global generator; pass "
                f"generator= a seeded torch.Generator",
            )
        elif parts[0] != "torch" or len(parts) > 2:
            self._check_inplace_rng(node, parts[-1])

    def _check_inplace_rng(self, node, attr: str):
        if attr in _TORCH_RNG_INPLACE and not self._has_generator(node):
            self._emit(
                "DET001", node,
                f".{attr}() fills from torch's global generator; pass "
                f"generator= a seeded torch.Generator",
            )

    @staticmethod
    def _is_float(node) -> bool:
        """A float literal, a negated one, float(...) or a list/tuple
        holding one."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, float)
        if isinstance(node, ast.UnaryOp):
            return _Linter._is_float(node.operand)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            return node.func.id == "float"
        if isinstance(node, (ast.List, ast.Tuple)):
            return any(_Linter._is_float(e) for e in node.elts)
        return False

    def _check_factory(self, node, dotted: str):
        parts = dotted.split(".")
        if (len(parts) != 2 or parts[0] != "torch"
                or any(kw.arg == "dtype" for kw in node.keywords)):
            return
        name = parts[1]
        if name in _TORCH_FLOAT_FACTORIES or (
                name in _TORCH_VALUE_FACTORIES
                and any(self._is_float(a) for a in node.args)):
            self._emit(
                "DET005", node,
                f"{dotted}() without dtype= makes torch's default float "
                f"type (float32) in a declared float64 scheduling path; "
                f"pass dtype=",
            )

    def _check_rng(self, node, dotted: str):
        parts = dotted.split(".")
        if (len(parts) >= 3 and parts[0] == "numpy" and parts[1] == "random"
                and parts[-1] in _NP_GLOBAL_RNG):
            self._emit(
                "DET001", node,
                f"{dotted}() draws from the global numpy RNG; use a seeded "
                f"np.random.default_rng(seed) generator",
            )
        elif (len(parts) == 2 and parts[0] == "random"
              and parts[1] in _STDLIB_RNG):
            self._emit(
                "DET001", node,
                f"{dotted}() draws from the hidden global random.Random; "
                f"use a seeded random.Random(seed) instance",
            )

    def _check_clock(self, node, dotted: str):
        if not self.is_engine or dotted not in _WALL_CLOCK:
            return
        if self._allowed_timing():
            return
        self._emit(
            "DET002", node,
            f"{dotted}() reads the wall clock inside an engine module; "
            f"engines must consume simulated/injected time only (or add "
            f"the enclosing function to the manifest TIMING_ALLOWLIST)",
        )

    # -- DET003 --------------------------------------------------------------

    def visit_Assign(self, node: ast.Assign):
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            if self._is_set_expr(node.value):
                self.set_names[-1].add(node.targets[0].id)
            else:
                self.set_names[-1].discard(node.targets[0].id)
        self.generic_visit(node)

    def _is_set_expr(self, node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            return node.func.id in ("set", "frozenset")
        return False

    def _iter_is_set(self, node) -> bool:
        if self._is_set_expr(node):
            return True
        if isinstance(node, ast.Name):
            return any(node.id in names for names in self.set_names)
        return False

    def visit_For(self, node: ast.For):
        if self._iter_is_set(node.iter) and self._body_accumulates(node.body):
            self._emit(
                "DET003", node,
                "iterating a set in salted hash order feeds an accumulation "
                "or emission; iterate sorted(...) instead",
            )
        self.generic_visit(node)

    def _body_accumulates(self, body) -> bool:
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.AugAssign):
                    return True
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _EMIT_METHODS):
                    return True
        return False

    # -- DET005 --------------------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute):
        if (self.in_f64_path and node.attr in _F32_ATTRS
                and not self._allowed_f32()):
            self._emit(
                "DET005", node,
                f".{node.attr} in a declared float64 scheduling path; the "
                f"bitwise cross-engine contract requires float64 (or a "
                f"manifest allowance with a tolerance-bound test)",
            )
        self.generic_visit(node)

    def _check_dtype_string(self, node: ast.Call):
        candidates = []
        for kw in node.keywords:
            if kw.arg == "dtype":
                candidates.append(kw.value)
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in ("astype", "view"):
            candidates.extend(node.args[:1])
        for c in candidates:
            if (isinstance(c, ast.Constant) and isinstance(c.value, str)
                    and c.value in _F32_STRINGS):
                self._emit(
                    "DET005", c,
                    f"dtype string {c.value!r} in a declared float64 "
                    f"scheduling path",
                )

    # -- DET006 --------------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.type is None:
            self._emit(
                "DET006", node,
                "bare except: swallows KeyboardInterrupt/SystemExit; catch "
                "Exception (or narrower)",
            )
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        operands = [node.left] + list(node.comparators)
        for i, op in enumerate(node.ops):
            if isinstance(op, (ast.Is, ast.IsNot)):
                for side in (operands[i], operands[i + 1]):
                    if (isinstance(side, ast.Constant)
                            and side.value is not None
                            and side.value is not True
                            and side.value is not False):
                        self._emit(
                            "DET006", node,
                            f"'is' comparison against literal "
                            f"{side.value!r}; identity of interned values "
                            f"is an implementation detail — use ==",
                        )
                        break
        self.generic_visit(node)

    # DET005 dtype-string check rides on every call
    def generic_visit(self, node):
        if (isinstance(node, ast.Call) and self.in_f64_path
                and not self._allowed_f32()):
            self._check_dtype_string(node)
        super().generic_visit(node)


# -- entry points ------------------------------------------------------------


def lint_source(
    source: str, path: str, config: Optional[DetlintConfig] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Lint one file's source. Returns ``(findings, suppressed)`` where
    ``suppressed`` are findings silenced by an inline
    ``# detlint: disable=...`` comment on their line."""
    if config is None:
        config = default_config()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("DET000", path, e.lineno or 1,
                        f"syntax error: {e.msg}")], []
    lines = source.splitlines()
    linter = _Linter(path, lines, config)
    linter.visit(tree)
    suppress = _suppressions(source)
    active, suppressed = [], []
    for f in sorted(linter.findings, key=lambda f: (f.line, f.rule)):
        if f.rule in suppress.get(f.line, ()):
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed


def iter_lint_files(root: str,
                    subdirs: Sequence[str] = ("src/repro_torch",
                                              "examples_torch"),
                    ) -> Iterable[str]:
    """Yield repo-relative posix paths of the .py files detlint covers."""
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base) and base.endswith(".py"):
            yield os.path.relpath(base, root).replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, name), root)
                    yield rel.replace(os.sep, "/")


def lint_paths(
    root: str,
    paths: Optional[Sequence[str]] = None,
    config: Optional[DetlintConfig] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Lint ``paths`` (repo-relative; default: the whole of
    ``src/repro_torch/`` and ``examples_torch/``) under ``root``. Returns
    ``(findings, suppressed)``."""
    if config is None:
        config = default_config()
    if paths is None:
        paths = list(iter_lint_files(root))
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for rel in paths:
        with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
            source = f.read()
        got, sup = lint_source(source, rel, config)
        findings.extend(got)
        suppressed.extend(sup)
    return findings, suppressed
