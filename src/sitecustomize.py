"""Interpreter start-up shim for running the JAX reference on newer JAX.

JAX 0.9 removed ``jax.experimental.enable_x64``; several modules of the
reference package still import it. With ``src`` on ``PYTHONPATH`` Python
imports this module at start-up, and it restores the name as an alias of
``jax.enable_x64`` the first time ``jax.experimental`` is imported.

It imports nothing of JAX itself, so a process that never imports JAX pays
nothing, and it does nothing where JAX is not installed or where JAX still
has the name.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys

_TARGET = "jax.experimental"


def _alias_enable_x64(module) -> None:
    if not hasattr(module, "enable_x64"):
        import jax

        module.enable_x64 = lambda new_val=True: jax.enable_x64(new_val)


class _EnableX64Alias(importlib.abc.MetaPathFinder):
    """Finds ``jax.experimental`` through the other finders and wraps its
    loader so the alias is set right after the module has executed."""

    def find_spec(self, fullname, path, target=None):
        if fullname != _TARGET:
            return None
        spec = importlib.machinery.PathFinder.find_spec(fullname, path, target)
        if spec is None or spec.loader is None:
            return spec
        exec_module = spec.loader.exec_module

        def exec_and_alias(module):
            exec_module(module)
            _alias_enable_x64(module)

        spec.loader.exec_module = exec_and_alias
        return spec


if _TARGET in sys.modules:
    _alias_enable_x64(sys.modules[_TARGET])
else:
    sys.meta_path.insert(0, _EnableX64Alias())
