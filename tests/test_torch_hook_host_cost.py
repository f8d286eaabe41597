"""``tools/hook_host_cost.py``, the host time of the cost count's hooks
in the model code where no count is active: it times each hook and
reports a finite figure for each."""

import importlib.util
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "hook_host_cost", ROOT / "tools" / "hook_host_cost.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_each_hook_is_timed():
    out = _tool().measure(calls=200, repeats=1)
    assert set(out["us_per_call"]) == {"partitioned", "run_plain",
                                       "time_loop"}
    assert all(math.isfinite(v) for v in out["us_per_call"].values())
    assert out["torch"]
