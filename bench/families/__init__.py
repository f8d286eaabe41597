"""Model families beyond the two built into the benchmark.

The reference (``reference/lm.py``), the costs (``costs/``) and the implied
launches (``harness/launches.py``) know the dense GQA decoder (``dense``)
and the encoder-decoder (``encdec``). A configuration whose models are of
another family brings ``bench/families/<family>.py``, which defines what
those modules would, for one model's configuration ``lm``:

* ``exit_logits(weights, lm, tokens, exits, src=None, fp8=False)``: the
  plain float32 reference (float8 products with ``fp8``), as
  ``reference.lm.exit_logits``;
* ``quantum_launches(lm, exit_idx)``: launches of the port's kernels in
  one served quantum, as ``harness.launches.quantum_launches``;
* ``quantum_calls(lm, exit_idx, batch, prompt_len)``: its flash-attention
  and exit-head calls, as ``costs.kernels.quantum_calls``;
* ``quantum_flops(lm, exit_idx, batch, prompt_len)``: its model
  operations, as ``costs.model.quantum_flops``.

The harness finds the file by the family's name, so adding a family edits
no file that is already here.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType

BUILT_IN = ("dense", "encdec")


def module(family: str) -> ModuleType:
    """``families/<family>.py``; a family with no such file is refused."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", family):
        raise ValueError(f"not a family name: {family!r}")
    try:
        return importlib.import_module(f"{__name__}.{family}")
    except ModuleNotFoundError as err:
        if err.name != f"{__name__}.{family}":
            raise
        raise ValueError(
            f"no family {family!r}: the benchmark knows {BUILT_IN} and "
            f"the files under bench/families/") from None
