"""The port's launch layer (``repro_torch.analysis.launch_audit``): seeded
plans past each launch limit give their finding (grid.y of 65536, 1025
threads, 240 KB of shared memory, a block past the end, and the rest of
LCH001-LCH003), also through ``run_suite`` with file and line; every real
``launch_plan`` is clean at its envelopes; a wrapper refuses a shape past
a limit before any launch; and, as the card's audit phase reads them, the
C plan is compared row for row with the Python one (LCH000) and ptxas's
report is parsed into registers, spills and static shared memory
(LCH004).
"""

import os
import sys
import types

import pytest

from repro_torch.analysis import launch_audit
from repro_torch.analysis.launch_audit import audit_launch, mangled
from repro_torch.analysis.manifest import KERNEL_SPECS, KernelSpec
from repro_torch.analysis.runner import run_suite
from repro_torch.kernels import checks
from repro_torch.kernels.checks import Launch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHERE = ("src/repro_torch/kernels/x/ops.py", 7)


def _rules(launch, **kw):
    return sorted(f.rule for f in audit_launch(launch, kernel="x",
                                               where=WHERE, **kw))


def _ok(**kw):
    fields = dict(entry="k<1>", grid=(4, 2, 1), block=(128, 1, 1),
                  tiles=((0, 64, 256, False), (1, 1, 2, False)))
    fields.update(kw)
    return Launch(**fields)


def test_a_good_launch_is_clean():
    assert _rules(_ok()) == []


@pytest.mark.parametrize("fields,rule,detail", [
    (dict(grid=(4, 65536, 1), tiles=()), "LCH001", "grid.y"),
    (dict(grid=(4, 1, 65536), tiles=()), "LCH001", "grid.z"),
    (dict(grid=(2 ** 31, 1, 1), tiles=()), "LCH001", "grid.x"),
    (dict(grid=(0, 1, 1), tiles=()), "LCH001", "grid.x"),
    (dict(block=(1025, 1, 1)), "LCH001", "block"),
    (dict(block=(32, 32, 2)), "LCH001", "block"),
    (dict(block=(100, 1, 1)), "LCH001", "block.warps"),
    (dict(cluster=16, grid=(16, 2, 1), tiles=()), "LCH001", "cluster"),
    (dict(cluster=3), "LCH001", "cluster"),
    (dict(grid=(5, 2, 1)), "LCH002", "past[0]"),
    (dict(grid=(3, 2, 1)), "LCH002", "cover[0]"),
    (dict(tiles=((0, 32, 256, True),), grid=(9, 1, 1)), "LCH002",
     "stride[0]"),
    (dict(index32=(("w", 2 ** 31),)), "LCH002", "index32[w]"),
    (dict(smem=240 * 1024, optin=True), "LCH003", "smem"),
    (dict(smem=64 * 1024), "LCH003", "smem.optin"),
])
def test_seeded_launch_gives_its_finding(fields, rule, detail):
    found = audit_launch(_ok(**fields), kernel="x", where=WHERE)
    assert [f.rule for f in found] == [rule]
    assert found[0].snippet.endswith(detail)
    assert found[0].format().startswith(f"{WHERE[0]}:{WHERE[1]}: {rule}")


def test_static_shared_memory_counts_on_the_card():
    launch = _ok(smem=200 * 1024, optin=True)
    assert _rules(launch) == []
    assert _rules(launch, static_smem=40 * 1024) == ["LCH003"]


def test_grid_stride_axis_needs_one_block_and_none_past():
    strided = ((0, 128, 1000, True),)
    assert _rules(_ok(grid=(1, 1, 1), tiles=strided)) == []
    assert _rules(_ok(grid=(8, 1, 1), tiles=strided)) == []
    assert _rules(_ok(grid=(9, 1, 1), tiles=strided)) == ["LCH002"]


def test_segments_on_one_axis_add_up():
    two = ((0, 8, 20, False), (0, 8, 9, False))   # 3 + 2 blocks
    assert _rules(_ok(grid=(5, 1, 1), tiles=two)) == []
    assert _rules(_ok(grid=(6, 1, 1), tiles=two)) == ["LCH002"]


@pytest.mark.parametrize("spec", KERNEL_SPECS,
                         ids=[s.name for s in KERNEL_SPECS])
def test_every_real_plan_is_clean_at_its_envelopes(spec):
    findings, n = launch_audit.audit_kernel(spec)
    assert n >= 3
    assert findings == [], [f.format() for f in findings]
    ops = spec.ops()
    entries = getattr(ops, spec.entries)
    assert len(set(entries)) == len(entries)
    for args in spec.envelopes():
        for launch in getattr(ops, spec.plan)(**args):
            assert launch.entry in entries
            row = launch.row(entries)
            assert len(row) == checks.PLAN_FIELDS


def _seeded_module(threads):
    mod = types.ModuleType("seeded_plan_ops")
    mod.ENTRIES = ("seeded<1>",)
    mod.PLAN_ARGTYPES = []

    def launch_plan(n):
        return (Launch("seeded<1>", (checks.cdiv(n, threads), 1, 1),
                       (threads, 1, 1),
                       tiles=((0, threads, n, False),)),)

    mod.launch_plan = launch_plan
    mod.plan_c_args = lambda n: (n,)
    return mod


def test_seeded_plan_fails_the_suite(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "seeded_plan_ops",
                        _seeded_module(1056))
    spec = KernelSpec(name="seeded", module="seeded_plan_ops",
                      envelopes=lambda: [dict(n=4096)])
    report = run_suite(REPO_ROOT, layers=("launch",), kernel_specs=[spec],
                       baseline_path=str(tmp_path / "baseline.json"))
    assert report.exit_code == 1
    out = report.format()
    assert "LCH001" in out and "1056 threads" in out
    assert "tests/test_torch_launch_audit.py:" in out


def test_wrapper_refuses_a_shape_past_a_limit():
    """The exit head's pass 1 by 8 rows: grid.y is T / 8, at most 65535."""
    ok = dict(t=8 * 65535, d=4096, v=4096, dtype=1, aligned=1)
    card = (("n_sm", 132), ("per_sm", 2))
    with checks.recording() as launched:
        checks.launching("exit_head", card, **ok)
        with pytest.raises(ValueError, match="LCH001"):
            checks.launching("exit_head", card, **dict(ok, t=8 * 65535 + 1))
    assert launched["exit_head"] == {tuple(ok.items()),
                                     tuple(dict(ok, t=8 * 65535 + 1).items())}
    checks.launching("exit_head", card, **dict(ok, t=8))
    assert launched["exit_head"] == {tuple(ok.items()),
                                     tuple(dict(ok, t=8 * 65535 + 1).items())}


def test_refused_plan_raises_and_is_not_a_finding():
    from repro_torch.kernels.exit_head import ops

    with pytest.raises(ValueError):
        ops.launch_plan(t=4, d=512, v=4100, dtype=1, aligned=1)
    spec = next(s for s in KERNEL_SPECS if s.name == "exit_head")
    assert launch_audit.audit_kernel(spec, [dict(
        t=4, d=512, v=4100, dtype=1, aligned=1)]) == ([], 1)


def test_c_plan_compared_row_for_row(monkeypatch):
    spec = next(s for s in KERNEL_SPECS if s.name == "flash_attention")
    ops = spec.ops()
    env = [dict(b=2, h=8, kh=2, s=300, d=64, dtype=1)]

    def same(kernel, argtypes, *args):
        return tuple(l.row(ops.ENTRIES) for l in ops.launch_plan(*args))

    monkeypatch.setattr(checks, "c_plan", same)
    assert launch_audit.c_plan_findings(spec, env) == ([], 1)

    def off_by_one(kernel, argtypes, *args):
        (row,) = same(kernel, argtypes, *args)
        return (row[:3] + (row[3] + 1,) + row[4:],)

    monkeypatch.setattr(checks, "c_plan", off_by_one)
    found, n = launch_audit.c_plan_findings(spec, env)
    assert n == 1 and [f.rule for f in found] == ["LCH000"]
    assert found[0].path == "src/repro_torch/csrc/flash_attention.cu"


@pytest.mark.parametrize("entry,want", [
    ("tc::flash_attention_kernel<64>",
     "2tc22flash_attention_kernelILi64EEE"),
    ("f32::dq_kernel<float, 64>", "3f329dq_kernelIfLi64EEE"),
    ("exit_head_tiles<bf16, 8, true>",
     "15exit_head_tilesI13__nv_bfloat16Li8ELb1EEE"),
    ("exit_head_fold", "14exit_head_foldE"),
])
def test_mangled_entry_names(entry, want):
    assert mangled(entry) == want


REPORT = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d303f329dq_kernelIfLi64EEEvNS0_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d303f329dq_kernelIfLi64EEEvNS0_4ArgsIT_EE
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, 1024 bytes smem, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d303f3210dkv_kernelIfLi64EEEvNS0_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d303f3210dkv_kernelIfLi64EEEvNS0_4ArgsIT_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, 560 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_spills_and_smem():
    rows = launch_audit.ptxas_entries(REPORT)
    dq = rows["_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_04843d303f329dq_kernelIfLi64EEEvNS0_4ArgsIT_EE"]
    assert dq == {"spill_stores": 8, "spill_loads": 8, "registers": 80,
                  "smem_static": 1024}
    launches = [Launch("f32::dq_kernel<float, 64>", (1, 1, 1), (256, 1, 1)),
                Launch("f32::dkv_kernel<float, 64>", (1, 1, 1),
                       (512, 1, 1)),
                Launch("tc::dq_kernel<64>", (1, 1, 1), (128, 1, 1))]
    found, used = launch_audit.ptxas_findings("flash_attention_bwd",
                                              launches, REPORT)
    assert [f.snippet for f in found] == [
        "flash_attention_bwd::f32::dq_kernel<float, 64>::spill",
        "flash_attention_bwd::f32::dkv_kernel<float, 64>::registers",
        "flash_attention_bwd::tc::dq_kernel<64>::ptxas-missing"]
    assert all(f.rule == "LCH004" for f in found)
    assert set(used) == {"f32::dq_kernel<float, 64>",
                         "f32::dkv_kernel<float, 64>"}


def test_the_baseline_holds_the_known_spill():
    from repro_torch.analysis.baseline import Baseline

    base = Baseline.load(os.path.join(REPO_ROOT, "tools",
                                      "lint_torch_baseline.json"))
    found, _ = launch_audit.ptxas_findings(
        "flash_attention_bwd",
        [Launch("f32::dq_kernel<float, 64>", (1, 1, 1), (256, 1, 1))],
        REPORT)
    new, accepted, _ = base.split(found)
    assert new == [] and len(accepted) == 1
    assert all(e["justification"] for e in base.entries)
