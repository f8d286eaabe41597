"""Hand-written Hopper kernels of the port, one package per kernel.

Each package has ``ops.py`` (the wrapper: checks, launches, counts) and
``ref.py`` (the plain PyTorch version of the same function). A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises. ``launch_counts`` counts kernel launches by name; only a
wrapper's launch adds to it, so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import collections
from typing import Counter

launch_counts: Counter = collections.Counter()


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    launch_counts.clear()
