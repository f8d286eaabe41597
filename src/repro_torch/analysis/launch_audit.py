"""CUDA launch auditor: the geometry each kernel really launches, held to
the card's limits (the launch layer; the counterpart of
``src/repro/analysis/pallas_audit.py``).

Every ``csrc/<kernel>.cu`` computes its launches with one C++ function,
exported as ``<kernel>_plan`` (grid, block, dynamic shared memory, the
opt-in past 48 KB, the cluster), and its ops module mirrors it in Python
as ``launch_plan``, which adds what the kernel tiles and which tensors it
addresses with 32-bit offsets (``kernels/checks.py::Launch``). The audit
runs each plan at the kernel's envelopes (``manifest.KERNEL_SPECS``: the
reference's envelope and the serve cells of ``configs/shapes.py`` a
device at full width; on the card, also every shape that run launched,
gathered by ``kernels/checks.py::recording``), over the
whole range of a card-dependent argument, and checks, on the CPU:

  LCH001  grid and block limits: grid x at most 2^31 - 1, y and z at most
          65535, every dimension at least 1; a block at most 1024 threads
          (x, y at most 1024, z at most 64) and a multiple of 32; a
          cluster at most 8 blocks that divide grid x.
  LCH002  coverage and index bounds: the blocks on a tiled axis cover its
          extent and none starts wholly past it (a grid-stride axis: at
          least one block, none past its tiles); a tensor addressed with
          32-bit offsets has fewer than 2^31 elements.
  LCH003  shared memory: dynamic (plus, on the card, ptxas's static)
          bytes at most 232448 a block; past 48 KB the launch path opts
          in.

and on the card (``chip_smoke.py``'s audit phase, after the build):

  LCH000  the C plan differs from the Python plan (or refuses where it
          does not), at an envelope;
  LCH004  ptxas's registers x the plan's threads at most 65536 a block,
          and no spill.

A plan that raises (the C entry refuses the shape) is a refusal, not a
finding: the wrapper raises the same error before any launch. Before its
first launch at a set of arguments, each wrapper holds the plan on the
card it runs on to LCH001-LCH003 (``kernels/checks.py::launching`` ->
:func:`launch_findings`) and raises rather than launch past a limit.
"""

from __future__ import annotations

import inspect
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import manifest as _manifest
from repro_torch.analysis.detlint import Finding

__all__ = ["audit_launch", "launch_findings", "plan_findings", "audit_kernel",
           "audit_kernel_manifest", "c_plan_findings", "ptxas_entries",
           "ptxas_findings", "mangled", "MAX_SMEM", "DEFAULT_SMEM"]

MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_THREADS = 1024
MAX_CLUSTER = 8
MAX_SMEM = 232448          # a block's shared memory on sm_90 (227 KB)
DEFAULT_SMEM = 48 * 1024   # without the opt-in
MAX_REGS = 65536           # an SM's register file
INDEX32 = 2 ** 31


def audit_launch(launch, *, kernel: str, where: Tuple[str, int],
                 args: Optional[dict] = None,
                 static_smem: int = 0) -> List[Finding]:
    """LCH001-LCH003 on one planned launch (a ``kernels/checks.Launch``).
    ``static_smem``: ptxas's static shared memory of the entry, where
    known."""
    at = f" at {args}" if args else ""
    tag = f"{kernel}::{launch.entry}"
    out: List[Finding] = []

    def add(rule, what, detail):
        out.append(Finding(rule, where[0], where[1],
                           f"{tag}{at}: {what}",
                           snippet=f"{tag}::{detail}"))

    gx, gy, gz = launch.grid
    bx, by, bz = launch.block
    if not 1 <= gx <= MAX_GRID_X:
        add("LCH001", f"grid.x = {gx} outside [1, {MAX_GRID_X}]", "grid.x")
    for axis, g in (("y", gy), ("z", gz)):
        if not 1 <= g <= MAX_GRID_YZ:
            add("LCH001", f"grid.{axis} = {g} outside [1, {MAX_GRID_YZ}]",
                f"grid.{axis}")
    threads = bx * by * bz
    if (min(bx, by, bz) < 1 or bx > MAX_THREADS or by > MAX_THREADS
            or bz > 64 or threads > MAX_THREADS):
        add("LCH001", f"block {launch.block} ({threads} threads) outside "
                      f"the limits (at most {MAX_THREADS} threads)", "block")
    elif threads % 32:
        add("LCH001", f"block of {threads} threads is not whole warps",
            "block.warps")
    if launch.cluster < 1 or launch.cluster > MAX_CLUSTER or (
            gx % launch.cluster):
        add("LCH001", f"cluster of {launch.cluster} blocks (grid.x {gx}): "
                      f"at most {MAX_CLUSTER}, dividing grid.x", "cluster")

    by_axis: Dict[int, List[Tuple[int, int, bool]]] = {}
    for axis, tile, extent, strided in launch.tiles:
        by_axis.setdefault(axis, []).append((tile, extent, strided))
    for axis, parts in sorted(by_axis.items()):
        g = launch.grid[axis]
        need = sum(-(-extent // tile) for tile, extent, _ in parts)
        if any(strided for *_, strided in parts):
            if not 1 <= g <= need:
                add("LCH002", f"grid-stride axis {axis} has {g} blocks for "
                              f"{need} tiles", f"stride[{axis}]")
        elif g < need:
            add("LCH002", f"axis {axis}: {g} blocks leave part of "
                          f"{[e for _, e, _ in parts]} uncovered "
                          f"({need} needed)", f"cover[{axis}]")
        elif g > need:
            add("LCH002", f"axis {axis}: {g - need} block(s) start wholly "
                          f"past the extent ({need} cover it)",
                f"past[{axis}]")
    for name, elements in launch.index32:
        if elements >= INDEX32:
            add("LCH002", f"{name} has {elements} elements, addressed with "
                          f"32-bit offsets", f"index32[{name}]")

    smem = launch.smem + static_smem
    if smem > MAX_SMEM:
        add("LCH003", f"{smem} bytes of shared memory a block "
                      f"({launch.smem} dynamic, {static_smem} static) past "
                      f"{MAX_SMEM}", "smem")
    if launch.smem > DEFAULT_SMEM and not launch.optin:
        add("LCH003", f"{launch.smem} bytes of dynamic shared memory past "
                      f"48 KB without the opt-in", "smem.optin")
    return out


def _plan_location(spec) -> Tuple[str, int]:
    fn = getattr(spec.ops(), spec.plan)
    try:
        path = inspect.getsourcefile(fn) or spec.module
        return path, inspect.getsourcelines(fn)[1]
    except (TypeError, OSError):
        return spec.module, 1


def _launches(spec, args: dict, point: dict):
    return getattr(spec.ops(), spec.plan)(**args, **point)


def launch_findings(kernel: str, args: dict, point: dict) -> List[Finding]:
    """LCH001-LCH003 of the launches a wrapper is about to make: the plan
    of ``kernel`` at ``args`` on this card (``point``: its card-dependent
    arguments, none where the plan has none). The findings name the ops
    module, whose source is not read."""
    spec = _manifest.kernel_spec(kernel)
    found: List[Finding] = []
    for launch in _launches(spec, args, point):
        found += audit_launch(launch, kernel=kernel, where=(spec.module, 0),
                              args=args)
    return found


def plan_findings(kernel, args: dict) -> List[Finding]:
    """LCH001-LCH003 of a kernel's Python plan at ``args`` (``kernel``: its
    name in the manifest, or a ``KernelSpec``), over every card-dependent
    argument in its range; a plan that refuses raises its ``ValueError``."""
    spec = (_manifest.kernel_spec(kernel) if isinstance(kernel, str)
            else kernel)
    kernel = spec.name
    where = _plan_location(spec)
    found: List[Finding] = []
    seen = set()
    for point in _manifest.device_points(spec):
        for launch in _launches(spec, args, point):
            for f in audit_launch(launch, kernel=kernel, where=where,
                                  args=args):
                if f.fingerprint not in seen:
                    seen.add(f.fingerprint)
                    found.append(f)
    return found


def audit_kernel(spec, envelopes: Optional[Sequence[dict]] = None
                 ) -> Tuple[List[Finding], int]:
    """(findings, envelopes audited) of one
    :class:`~repro_torch.analysis.manifest.KernelSpec` at its envelopes
    (or ``envelopes``)."""
    if envelopes is None:
        envelopes = spec.envelopes()
    envelopes = _manifest.dedup(envelopes)
    findings: List[Finding] = []
    seen = set()
    for args in envelopes:
        try:
            got = plan_findings(spec, args)
        except ValueError:
            continue   # refused: the wrapper raises before any launch
        for f in got:
            if f.fingerprint not in seen:
                seen.add(f.fingerprint)
                findings.append(f)
    return findings, len(envelopes)


def audit_kernel_manifest(specs: Optional[Sequence] = None
                          ) -> List[Finding]:
    if specs is None:
        specs = _manifest.KERNEL_SPECS
    findings: List[Finding] = []
    for spec in specs:
        findings.extend(audit_kernel(spec)[0])
    return findings


# ---------------------------------------------------------------------------
# on the card: the C plans and ptxas's report
# ---------------------------------------------------------------------------


def c_plan_findings(spec, envelopes: Iterable[dict],
                    points: Optional[Sequence[dict]] = None
                    ) -> Tuple[List[Finding], int]:
    """LCH000: ``<kernel>_plan`` in the built library against the Python
    plan at every envelope and card-dependent point (needs the built
    kernel). Returns (findings, plans compared)."""
    from repro_torch.kernels import checks

    ops = spec.ops()
    entries = getattr(ops, spec.entries)
    argtypes = getattr(ops, spec.argtypes)
    where = (f"src/repro_torch/csrc/{spec.name}.cu", 1)
    findings: List[Finding] = []
    compared = 0
    for args in _manifest.dedup(list(envelopes)):
        for point in (points if points is not None
                      else _manifest.device_points(spec)):
            c_args = getattr(ops, spec.c_args)(**args, **point)
            try:
                want = tuple(l.row(entries) for l in
                             _launches(spec, args, point))
            except ValueError:
                want = None
            try:
                got = checks.c_plan(spec.name, argtypes, *c_args)
            except ValueError:
                got = None
            compared += 1
            if got != want:
                findings.append(Finding(
                    "LCH000", *where,
                    f"{spec.name} at {args} {point}: the C plan {got} "
                    f"differs from launch_plan's {want}",
                    snippet=f"{spec.name}::plan::{sorted(args.items())}"))
    return findings, compared


def mangled(entry: str) -> str:
    """The Itanium-mangled name of a kernel entry inside the sources'
    anonymous namespace, up to its parameters: ``tc::flash_attention_
    kernel<64>`` -> ``2tc22flash_attention_kernelILi64EEE``. nvcc names the
    anonymous namespace after the file (``_ZN47_GLOBAL__N__<hash>_14_
    rmsnorm_bwd_cu_<hash>...``); :func:`_in_anonymous` strips that."""
    ns, _, rest = entry.rpartition("::")
    name, _, targs = rest.partition("<")
    out = "".join(f"{len(p)}{p}" for p in ns.split("::") if p)
    out += f"{len(name)}{name}"
    if targs:
        codes = {"float": "f", "bf16": "13__nv_bfloat16", "true": "Lb1E",
                 "false": "Lb0E"}
        out += "I" + "".join(codes.get(a.strip(), f"Li{a.strip()}E")
                             for a in targs.rstrip(">").split(",")) + "E"
    return out + "E"


def _in_anonymous(name: str) -> str:
    """A mangled name past its leading anonymous namespace (the whole name
    where it has none)."""
    m = re.match(r"_ZN(\d+)", name)
    if m is None:
        return name
    start = m.end()
    n = int(m.group(1))
    if name[start:start + n].startswith("_GLOBAL__N"):
        return name[start + n:]
    return name


def ptxas_entries(report: str) -> Dict[str, dict]:
    """nvcc's ``-Xptxas -v`` report, by mangled entry: registers, spill
    stores and loads (bytes) and static shared memory (bytes)."""
    rows: Dict[str, dict] = {}
    entry = None
    for line in report.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?(_Z\w+)'?", line)
        if m:
            entry = rows.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        spill = re.findall(r"(\d+) bytes spill (stores|loads)", line)
        for n, kind in spill:
            entry[f"spill_{kind}"] = int(n)
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            entry["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["smem_static"] = int(smem.group(1)) if smem else 0
    return rows


def ptxas_findings(kernel: str, launches: Iterable, report: str,
                   envelope_args: Optional[dict] = None
                   ) -> Tuple[List[Finding], Dict[str, dict]]:
    """LCH004 (and LCH003 with the static bytes) for each entry that
    ``launches`` (planned launches) use, from this build's ptxas report.
    Returns (findings, the report's row of each entry used)."""
    rows = ptxas_entries(report)
    where = (f"src/repro_torch/csrc/{kernel}.cu", 1)
    findings: List[Finding] = []
    used: Dict[str, dict] = {}
    seen = set()
    for launch in launches:
        prefix = mangled(launch.entry)
        hits = [r for name, r in rows.items()
                if _in_anonymous(name).startswith(prefix)]
        tag = f"{kernel}::{launch.entry}"
        if not hits:
            if (tag, "missing") not in seen:
                seen.add((tag, "missing"))
                findings.append(Finding(
                    "LCH004", *where,
                    f"{tag}: no ptxas entry {prefix}* in this build's report",
                    snippet=f"{tag}::ptxas-missing"))
            continue
        row = hits[0]
        used[launch.entry] = row
        threads = launch.block[0] * launch.block[1] * launch.block[2]
        regs = row.get("registers", 0)
        if regs * threads > MAX_REGS and (tag, "regs") not in seen:
            seen.add((tag, "regs"))
            findings.append(Finding(
                "LCH004", *where,
                f"{tag}: {regs} registers x {threads} threads = "
                f"{regs * threads} past {MAX_REGS}",
                snippet=f"{tag}::registers"))
        spill = row.get("spill_stores", 0) + row.get("spill_loads", 0)
        if spill and (tag, "spill") not in seen:
            seen.add((tag, "spill"))
            findings.append(Finding(
                "LCH004", *where,
                f"{tag}: spills {row.get('spill_stores', 0)} bytes stored "
                f"and {row.get('spill_loads', 0)} loaded",
                snippet=f"{tag}::spill"))
        for f in audit_launch(launch, kernel=kernel, where=where,
                              args=envelope_args,
                              static_smem=row.get("smem_static", 0)):
            if f.rule == "LCH003" and f.fingerprint not in seen:
                seen.add(f.fingerprint)
                findings.append(f)
    return findings, used
