"""Small configurations for the benchmark's CPU tests, built from the
port's SMOKE model configs."""

from __future__ import annotations

import dataclasses
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def lm_dict(arch: str, dtype: str = "float32") -> dict:
    """The port's SMOKE config of ``arch`` as a configuration file's
    ``lm`` entry."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = dtype
    out["exits"] = list(out["exits"])
    return out


def small_config(archs=("phi4-mini-3.8b", "seamless-m4t-large-v2"),
                 dtype: str = "float32", limits=None) -> dict:
    """A configuration file's content at the SMOKE sizes."""
    return {
        "name": "small",
        "models": [{"name": a, "share": s, "lm": lm_dict(a, dtype)}
                   for a, s in zip(archs, (2, 1))],
        "prompt_len": 16, "max_batch": 8, "profile_batches": [1, 2, 4, 8],
        "slo_ms": 50.0, "knee_req_s": 100.0, "pool": 32, "check_rows": 24,
        "limits": limits or {"token_gap": 1e-3, "lse_gap": 1e-3,
                            "max_gap": 1e-3},
    }
