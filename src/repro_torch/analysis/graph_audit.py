"""aten-graph auditor: dtype contracts, host-sync denylist, recompile
guards (the graph layer; the counterpart of
``src/repro/analysis/jaxpr_audit.py``).

The AST layer sees source text; the bitwise contract lives in the aten ops
that actually run. Each artifact of the precision manifest is traced with
``torch.fx.experimental.proxy_tensor.make_fx`` under fake tensors (nothing
is computed), and every node's ``meta["val"]`` is checked:

  GRA001  dtype contract: a ``float64``-contract artifact holds no
          float32, float16 or bfloat16 value, input, intermediate or
          output (torch's default float32 is how the bitwise guarantee
          dies silently: the op still runs, the numbers are just a little
          wrong).
  GRA002  denylist: no op that syncs the host or that a CUDA graph cannot
          capture (``.item()``'s ``aten._local_scalar_dense``,
          ``aten.nonzero``, and the other ops whose output shape depends
          on the data), the counterpart of the host-callback denylist.
  GRA003  recompile guards: a sweep of SLOs, clips and drain caps through
          the port's graph caches (``simfast._scan_steps``,
          ``clusterfast._cluster_steps``, ``make_scoring_backend``: each an
          ``lru_cache``) adds no entry after the first call.
  GRA000  an artifact that fails to trace.

A finding names the file and line of the op's source: a dispatch mode
inside the trace records, for each aten op, the innermost frame outside
torch, in the order the graph's nodes are made.
"""

from __future__ import annotations

import os
import traceback
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis import manifest as _manifest
from repro_torch.analysis.detlint import Finding

__all__ = ["audit_graph", "audit_artifact", "audit_precision_manifest",
           "no_recompile_findings", "audit_recompile_guards", "trace",
           "NARROW_FLOATS", "DENYLISTED_OPS"]

NARROW_FLOATS = ("torch.float32", "torch.float16", "torch.bfloat16")

# aten ops (overload packets) that read a value back to the host or whose
# output shape depends on the data: each stalls the stream and breaks CUDA
# graph capture
DENYLISTED_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.nonzero",
    "aten.masked_select", "aten.unique_dim", "aten._unique",
    "aten._unique2", "aten.unique_consecutive", "aten.is_nonzero",
    "aten.equal", "aten.bincount", "aten.repeat_interleave.Tensor",
})

_TORCH_DIR = None


def _torch_dir() -> str:
    global _TORCH_DIR
    if _TORCH_DIR is None:
        import torch

        _TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
    return _TORCH_DIR


def _where() -> Tuple[str, int]:
    """The innermost frame of the current stack outside torch and this
    module."""
    here = os.path.abspath(__file__)
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path == here or path.startswith(_torch_dir()):
            continue
        return frame.filename, frame.lineno or 1
    return "<traced>", 1


def _op_name(target) -> str:
    """``aten.nonzero`` for ``aten.nonzero.default``."""
    name = str(target)
    packet = getattr(target, "overloadpacket", None)
    return str(packet) if packet is not None else name


def _stand_in(func, args):
    """What a denylisted op returns in the trace: a zero of the scalar's
    type (``.item()``), no rows (``nonzero``), an empty result otherwise;
    the trace goes on past it, as the graph would not."""
    import torch

    x = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if _op_name(func) in ("aten._local_scalar_dense", "aten.item",
                          "aten.is_nonzero", "aten.equal"):
        if x is None or x.dtype == torch.bool:
            return False
        return 0.0 if x.is_floating_point() else 0
    if x is None:
        return torch.zeros(0, dtype=torch.int64)
    if _op_name(func) == "aten.nonzero":
        return x.new_zeros((0, x.ndim), dtype=torch.int64)
    return x.new_zeros((0,))


def trace(fn, args):
    """``(graph module, [(op name, (file, line))] in dispatch order, the
    denylisted ops met)`` of ``fn(*args)`` traced with ``make_fx`` under
    fake tensors. A denylisted op (whose value the fake tensors do not
    hold) is recorded where it is called and stood in for."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._python_dispatch import TorchDispatchMode

    sites: List[Tuple[str, Tuple[str, int]]] = []
    denied: List[Tuple[str, Tuple[str, int]]] = []

    class _Locate(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            name = _op_name(func)
            if name in DENYLISTED_OPS or str(func) in DENYLISTED_OPS:
                denied.append((name, _where()))
                return _stand_in(func, a)
            sites.append((name, _where()))
            return func(*a, **(kw or {}))

    slots = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]

    def located(*vals):
        full = list(args)
        for i, v in zip(slots, vals):
            full[i] = v
        with _Locate():
            return fn(*full)

    # tensors the traced code makes or holds itself are constants of the
    # graph
    gm = make_fx(located, tracing_mode="fake", _allow_non_fake_inputs=True)(
        *(args[i] for i in slots))
    return gm, sites, denied


def _node_dtypes(val) -> List[str]:
    vals = val if isinstance(val, (tuple, list)) else (val,)
    return [str(v.dtype) for v in vals if hasattr(v, "dtype")]


def audit_graph(gm, sites, denied=(), *, name: str,
                dtype_contract: str = "float64", path: str = "<traced>",
                line: int = 1) -> List[Finding]:
    """Check one traced graph against its dtype contract and the
    denylist (with the denylisted ops ``trace`` met). ``sites`` locates the
    call_function nodes in order (a node whose op the list does not reach
    next keeps the artifact's own location). Returns findings (empty ==
    clean)."""
    findings: List[Finding] = []
    seen = set()
    for op, where in denied:
        if ("GRA002", op, where) not in seen:
            seen.add(("GRA002", op, where))
            findings.append(_denied(name, op, where))
    cursor = 0
    for node in gm.graph.nodes:
        where = (path, line)
        if node.op == "call_function":
            op = _op_name(node.target)
            for j in range(cursor, len(sites)):
                if sites[j][0] == op:
                    where, cursor = sites[j][1], j + 1
                    break
        else:
            op = node.op
        if node.op == "call_function" and (
                op in DENYLISTED_OPS or str(node.target) in DENYLISTED_OPS):
            key = ("GRA002", op, where)
            if key not in seen:
                seen.add(key)
                findings.append(_denied(name, op, where))
        if dtype_contract != "float64" or node.op == "output":
            continue
        for dtype in _node_dtypes(node.meta.get("val")):
            if dtype in NARROW_FLOATS:
                key = ("GRA001", op, dtype, where)
                if key in seen:
                    continue
                seen.add(key)
                what = ("input" if node.op == "placeholder"
                        else f"op {op}")
                findings.append(Finding(
                    "GRA001", where[0], where[1],
                    f"artifact {name!r} declares float64 but its {what} "
                    f"holds {dtype.replace('torch.', '')}: a silent "
                    f"downcast on a bitwise-contract path",
                    snippet=f"{name}::{op}->{dtype.replace('torch.', '')}"))
    return findings


def _denied(name: str, op: str, where: Tuple[str, int]) -> Finding:
    return Finding(
        "GRA002", where[0], where[1],
        f"artifact {name!r} runs {op}, which syncs the host or has a "
        f"data-dependent shape: it stalls the stream and no CUDA graph can "
        f"capture it", snippet=f"{name}::{op}")


def _artifact_location(fn) -> Tuple[str, int]:
    import inspect

    target = fn
    for attr in ("__wrapped__", "func"):
        while hasattr(target, attr):
            target = getattr(target, attr)
    try:
        path = inspect.getsourcefile(target) or "<unknown>"
        _, line = inspect.getsourcelines(target)
        return path, line
    except (TypeError, OSError):
        return "src/repro_torch/analysis/manifest.py", 1


def audit_artifact(spec) -> List[Finding]:
    """Trace one manifest :class:`~repro_torch.analysis.manifest.ArtifactSpec`
    and audit its graph."""
    try:
        fn, args = spec.build()
        path, line = _artifact_location(fn)
        gm, sites, denied = trace(fn, args)
    except Exception as e:  # a failure to trace is itself a finding
        return [Finding(
            "GRA000", "src/repro_torch/analysis/manifest.py", 1,
            f"artifact {spec.name!r} failed to trace: "
            f"{type(e).__name__}: {e}",
            snippet=f"{spec.name}::trace-error")]
    return audit_graph(gm, sites, denied, name=spec.name,
                       dtype_contract=spec.dtype_contract, path=path,
                       line=line)


def audit_precision_manifest(artifacts: Optional[Sequence] = None
                             ) -> List[Finding]:
    """Audit every artifact of the manifest (or an injected list: the
    tests prove a polluted artifact is caught)."""
    if artifacts is None:
        artifacts = _manifest.PRECISION_ARTIFACTS
    findings: List[Finding] = []
    for spec in artifacts:
        findings.extend(audit_artifact(spec))
    return findings


# ---------------------------------------------------------------------------
# recompile guards
# ---------------------------------------------------------------------------


def no_recompile_findings(guard) -> List[Finding]:
    """Run one :class:`~repro_torch.analysis.manifest.RecompileGuard`
    sweep: the first call primes the cache, and the rest must add no
    entry (``cache_info().misses`` does not grow, so an eviction from a
    full cache still counts). A target with no ``cache_info`` is itself a
    finding: a guard measuring nothing."""
    cache, calls = guard.build()
    where = _artifact_location(cache)
    if not calls:
        return [Finding("GRA003", where[0], where[1],
                        f"recompile guard {guard.name!r} has no calls",
                        snippet=f"{guard.name}::empty")]
    info = getattr(cache, "cache_info", None)
    if info is None:
        return [Finding("GRA003", where[0], where[1],
                        f"recompile guard {guard.name!r}: the target has no "
                        f"cache_info (not an lru_cache?)",
                        snippet=f"{guard.name}::no-cache")]
    calls[0]()
    before = info()
    for call in calls[1:]:
        call()
    after = info()
    if after.misses > before.misses:
        return [Finding(
            "GRA003", where[0], where[1],
            f"recompile guard {guard.name!r}: the graph cache took "
            f"{after.misses - before.misses} new entr"
            f"{'y' if after.misses - before.misses == 1 else 'ies'} "
            f"(currsize {before.currsize}->{after.currsize}) across a value "
            f"sweep: a value became part of the key, so sweeps build a "
            f"graph per value",
            snippet=f"{guard.name}::recompiled")]
    return []


def audit_recompile_guards(guards: Optional[Sequence] = None
                           ) -> List[Finding]:
    if guards is None:
        guards = _manifest.RECOMPILE_GUARDS
    findings: List[Finding] = []
    for guard in guards:
        findings.extend(no_recompile_findings(guard))
    return findings
