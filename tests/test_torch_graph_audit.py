"""The port's graph layer (``repro_torch.analysis.graph_audit``): the
float64 scan steps trace clean; a seeded float32 intermediate and a seeded
``.item()`` are each flagged at their file and line, also through
``run_suite``; a cache keyed by a swept value trips the recompile guard;
and the float32 tiers stay inside their manifest ``rtol`` against the
float64 numpy backend at the four magnitudes of ``tests/test_analysis.py``'s
tolerance test (the counterpart of its stability-score downcast test).
"""

import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.analysis.graph_audit import (
    audit_artifact,
    no_recompile_findings,
    trace,
)
from repro_torch.analysis.manifest import (
    PRECISION_ARTIFACTS,
    ArtifactSpec,
    RecompileGuard,
)
from repro_torch.analysis.runner import run_suite

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)


def _polluted(w, tau):
    shifted = w.to(torch.float32) / tau   # the silent downcast
    return torch.exp(shifted.double() - 1.0).sum()


def _chatty(w, tau):
    n = int((w > tau).sum().item())   # a host sync
    return (w / tau).sum() * n


def _clean(w, tau):
    return torch.exp(w / tau - 1.0).sum()


def _line_of(fn, text):
    import inspect

    lines, first = inspect.getsourcelines(fn)
    return first + next(i for i, ln in enumerate(lines) if text in ln)


def _spec(fn, contract="float64"):
    return ArtifactSpec(name=fn.__name__, dtype_contract=contract,
                        build=lambda: (fn, (torch.ones((4, 4),
                                                       dtype=torch.float64),
                                            0.05)))


@pytest.mark.parametrize("spec", PRECISION_ARTIFACTS,
                         ids=[a.name for a in PRECISION_ARTIFACTS])
def test_manifest_artifacts_trace_clean(spec):
    assert audit_artifact(spec) == []


def test_clean_float64_step_passes():
    assert audit_artifact(_spec(_clean)) == []


def test_float32_intermediate_flagged_with_file_and_line():
    found = audit_artifact(_spec(_polluted))
    assert {f.rule for f in found} == {"GRA001"}
    line = _line_of(_polluted, "the silent downcast")
    assert all(os.path.abspath(f.path) == HERE and f.line == line
               for f in found), [f.format() for f in found]
    assert any("float32" in f.message for f in found)


def test_item_flagged_with_file_and_line():
    found = audit_artifact(_spec(_chatty))
    assert [f.rule for f in found] == ["GRA002"]
    assert os.path.abspath(found[0].path) == HERE
    assert found[0].line == _line_of(_chatty, "a host sync")
    assert "_local_scalar_dense" in found[0].message


def test_float32_contract_allows_float32_but_not_syncs():
    assert audit_artifact(_spec(_polluted, "float32")) == []
    assert [f.rule for f in audit_artifact(_spec(_chatty, "float32"))] == [
        "GRA002"]


def test_trace_failure_is_gra000():
    def broken():
        raise RuntimeError("boom")

    spec = ArtifactSpec(name="broken", dtype_contract="float64",
                        build=lambda: (broken, ()))
    assert [f.rule for f in audit_artifact(spec)] == ["GRA000"]


def test_trace_keeps_the_graph_and_its_sites():
    gm, sites, denied = trace(_polluted,
                              (torch.ones(3, dtype=torch.float64), 0.5))
    assert denied == []
    ops = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert "aten._to_copy.default" in ops
    assert sites and all(isinstance(line, int) for _, (_, line) in sites)


def test_polluted_artifact_fails_the_suite(tmp_path):
    report = run_suite(REPO_ROOT, layers=("graph",),
                       artifacts=[_spec(_polluted)], recompile_guards=[],
                       baseline_path=str(tmp_path / "baseline.json"))
    assert report.exit_code == 1
    out = report.format()
    assert "GRA001" in out and "tests/test_torch_graph_audit.py:" in out


@functools.lru_cache(maxsize=None)
def _graph_per_tau(tau):
    return object()


@functools.lru_cache(maxsize=None)
def _graph_per_shape(n):
    return object()


class TestRecompileGuards:
    def test_value_in_the_key_trips_the_guard(self):
        guard = RecompileGuard(
            name="keyed-by-tau",
            build=lambda: (_graph_per_tau, [
                functools.partial(_graph_per_tau, t)
                for t in (0.021, 0.051, 0.081)]))
        found = no_recompile_findings(guard)
        assert [f.rule for f in found] == ["GRA003"]
        assert "new entr" in found[0].message

    def test_value_out_of_the_key_is_clean(self):
        guard = RecompileGuard(
            name="keyed-by-shape",
            build=lambda: (_graph_per_shape, [
                (lambda t=t: _graph_per_shape(4)) for t in (0.02, 0.05)]))
        assert no_recompile_findings(guard) == []

    def test_uninstrumented_target_flagged(self):
        guard = RecompileGuard(name="opaque",
                               build=lambda: (len, [lambda: len("ab")]))
        found = no_recompile_findings(guard)
        assert [f.rule for f in found] == ["GRA003"]
        assert "cache_info" in found[0].message

    def test_manifest_guards_clean(self):
        from repro_torch.analysis.graph_audit import audit_recompile_guards

        assert audit_recompile_guards() == []


class TestFloat32TiersTolerance:
    """The declared float32 tiers against the float64 numpy backend at the
    magnitudes of ``tests/test_analysis.py``'s tolerance test."""

    RTOL = {a.name: a.rtol for a in PRECISION_ARTIFACTS
            if a.dtype_contract == "float32"}

    @staticmethod
    def _case(tau, lat_scale):
        rng = np.random.default_rng(17)
        m, q, n = 4, 16, 24
        w = np.sort(rng.uniform(0, 2 * tau, (m, q)))[:, ::-1].copy()
        mask = (rng.uniform(size=(m, q)) < 0.8).astype(np.float64)
        lat = rng.uniform(0.1 * lat_scale, lat_scale, n)
        bat = rng.integers(1, q, n)
        cq = rng.integers(0, m, n)
        return w, mask, lat, bat, cq

    @staticmethod
    def _rel(got, ref):
        denom = np.maximum(np.abs(ref), 1e-30)
        return np.max(np.abs(np.asarray(got, np.float64) - ref) / denom)

    MAGNITUDES = [(1e-3, 1e-6), (1e-3, 5e-3), (0.05, 0.02), (1e3, 1e2)]

    @pytest.mark.parametrize("tau,lat_scale", MAGNITUDES)
    def test_torch_backend(self, tau, lat_scale):
        from repro_torch.core.scoring import (
            NumpyScoringBackend,
            make_scoring_backend,
        )

        args = self._case(tau, lat_scale)
        ref = NumpyScoringBackend().score(*args, tau)
        got = make_scoring_backend("torch", "cpu").score(*args, tau)
        rel = self._rel(got, ref)
        assert rel <= self.RTOL["scoring.torch_backend"], (tau, lat_scale,
                                                           rel)

    @pytest.mark.parametrize("tau,lat_scale", MAGNITUDES)
    def test_stability_plain(self, tau, lat_scale):
        from repro_torch.core.scoring import NumpyScoringBackend
        from repro_torch.kernels.stability_score.ref import (
            stability_scores_plain,
        )

        w, mask, lat, bat, cq = self._case(tau, lat_scale)
        ref = NumpyScoringBackend().score(w, mask, lat, bat, cq, tau)
        f32 = torch.float32
        got = stability_scores_plain(
            torch.tensor(w, dtype=f32), torch.tensor(mask, dtype=f32),
            torch.tensor(lat, dtype=f32), torch.tensor(bat,
                                                       dtype=torch.int32),
            torch.tensor(cq, dtype=torch.int32), tau=tau, clip=10.0)
        rel = self._rel(got.numpy(), ref)
        assert rel <= self.RTOL["stability_score.plain"], (tau, lat_scale,
                                                           rel)
