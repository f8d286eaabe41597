"""Test-suite bootstrap: ``slow`` marker gating and a deterministic
fallback for ``hypothesis``.

``@pytest.mark.slow`` marks scaling checks (e.g. the 10^6-request scan run
in ``tests/test_simfast.py``) that belong in the dedicated CI smoke step,
not the tier-1 suite. They are skipped unless ``REPRO_RUN_SLOW`` is set.

Seven test modules use hypothesis property checks. On a fresh checkout
without dev dependencies (``pip install -r requirements-dev.txt``) the
import used to fail at collection and take the whole tier-1 suite down.
Instead of skipping those modules wholesale, this conftest registers a
minimal, deterministic stand-in that supports exactly the API surface the
suite uses (``given``, ``settings(max_examples=..., deadline=...)`` and the
``integers`` / ``floats`` / ``sampled_from`` strategies): each property
test then runs ``max_examples`` seeded-random examples, with the strategy
bounds exercised on the first draws.

With the real hypothesis installed (CI does), this file is a no-op and the
full shrinking/coverage machinery is used.
"""

from __future__ import annotations

import functools
import inspect
import os
import random
import sys
import types
import zlib

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: scaling checks run by the CI smoke step (REPRO_RUN_SLOW=1), "
        "skipped in tier-1",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips where there is none",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("REPRO_RUN_SLOW") or os.environ.get(
            "REPRO_SIMFAST_SMOKE"):
        return
    skip = pytest.mark.skip(reason="slow: set REPRO_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


try:  # real hypothesis wins whenever it is available
    import hypothesis  # noqa: F401
except ModuleNotFoundError:

    class _Strategy:
        """A draw function plus the boundary examples to try first."""

        def __init__(self, draw, corners=()):
            self._draw = draw
            self.corners = tuple(corners)

        def example(self, rng: random.Random, index: int):
            if index < len(self.corners):
                return self.corners[index]
            return self._draw(rng)

    def _integers(min_value: int, max_value: int) -> _Strategy:
        return _Strategy(
            lambda rng: rng.randint(min_value, max_value),
            corners=(min_value, max_value),
        )

    def _floats(min_value: float = 0.0, max_value: float = 1.0, **_kw) -> _Strategy:
        return _Strategy(
            lambda rng: rng.uniform(min_value, max_value),
            corners=(min_value, max_value),
        )

    def _sampled_from(elements) -> _Strategy:
        elements = list(elements)
        return _Strategy(lambda rng: rng.choice(elements))

    def _settings(max_examples: int = 25, deadline=None, **_kw):
        def deco(fn):
            fn._fallback_max_examples = max_examples
            return fn

        return deco

    def _given(**strategies):
        def deco(fn):
            sig = inspect.signature(fn)
            kept = [p for n, p in sig.parameters.items() if n not in strategies]

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_fallback_max_examples",
                            getattr(fn, "_fallback_max_examples", 25))
                rng = random.Random(zlib.crc32(fn.__qualname__.encode()))
                for i in range(n):
                    drawn = {k: s.example(rng, i) for k, s in strategies.items()}
                    fn(*args, **kwargs, **drawn)

            # pytest must see only the fixture params, not the drawn ones
            wrapper.__signature__ = sig.replace(parameters=kept)
            return wrapper

        return deco

    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_fallback__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
