"""Argument checks and launch plumbing shared by the kernels' wrappers."""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Dict, Iterator, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import build

# The dtype code every csrc launcher takes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# A csrc ``<kernel>_plan`` writes each launch as PLAN_FIELDS ints: entry,
# grid x y z, block x y z, dynamic shared memory bytes, opt-in, cluster.
PLAN_FIELDS = 10
MAX_LAUNCHES = 4

# kernel -> the distinct plan arguments it was launched with while a
# ``recording()`` is open (``launching``): the launch audit's envelope of
# what ran. None: nothing is recorded, as in a serving process.
_recorded: Optional[Dict[str, Set[Tuple[Tuple[str, int], ...]]]] = None


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a plan, as ``csrc/<kernel>.cu``'s
    ``<kernel>_plan`` computes it and ``kernels/<kernel>/ops.py``'s
    ``launch_plan`` mirrors it: the entry (a name of the ops module's
    ``ENTRIES``), grid and block, the dynamic shared memory bytes, whether
    the launch path opts in past 48 KB of it, and the blocks of a cluster
    along x. For the audit (``repro_torch/analysis/launch_audit.py``) the
    plan adds what the kernel tiles: ``tiles`` holds ``(axis, tile,
    extent, strided)``, blocks on grid ``axis`` each taking ``tile`` of
    ``extent`` elements (several on one axis share it, in order; a
    ``strided`` axis is walked grid-stride, so it needs at least one block
    and none past its tiles), and ``index32`` ``(tensor, elements)`` for
    the tensors the kernel addresses with 32-bit offsets."""

    entry: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem: int = 0
    optin: bool = False
    cluster: int = 1
    tiles: Tuple[Tuple[int, int, int, bool], ...] = ()
    index32: Tuple[Tuple[str, int], ...] = ()

    def row(self, entries: Sequence[str]) -> Tuple[int, ...]:
        """The C plan's ints for this launch."""
        return ((entries.index(self.entry),) + tuple(self.grid)
                + tuple(self.block) + (self.smem, int(self.optin),
                                       self.cluster))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def c_plan(kernel: str, argtypes: Sequence, *args) -> Tuple[tuple, ...]:
    """The launches ``csrc/<kernel>.cu``'s ``<kernel>_plan`` gives for
    ``args`` (its C arguments), each as its PLAN_FIELDS ints; raises where
    the launch path refuses them."""
    fn = launcher(kernel, f"{kernel}_plan",
                  list(argtypes) + [ctypes.c_void_p])
    buf = (ctypes.c_int * (PLAN_FIELDS * MAX_LAUNCHES))()
    n = fn(*args, buf)
    if n < 0:
        raise ValueError(f"{kernel}_plan refuses {args}")
    return tuple(tuple(buf[i * PLAN_FIELDS:(i + 1) * PLAN_FIELDS])
                 for i in range(n))


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, Set[Tuple[Tuple[str, int], ...]]]]:
    """Record, until the block ends, the plan arguments every kernel is
    launched with: kernel -> the set of ``tuple(plan_args.items())``."""
    global _recorded
    outer, _recorded = _recorded, {}
    try:
        yield _recorded
    finally:
        _recorded = outer


def launching(kernel: str, point: Tuple[Tuple[str, int], ...] = (),
              **plan_args: int) -> None:
    """Note that ``kernel`` launches now with ``plan_args`` (its ops
    module's ``launch_plan`` arguments; ``point``: the card-dependent
    ones, where its plan has any, as ``(name, value)`` pairs), recorded
    where a :func:`recording` is open, and raise ``ValueError`` before the
    launch where that plan on this card breaks a launch limit (the launch
    audit's rules LCH001-LCH003, checked once for each distinct set of
    arguments)."""
    key = tuple(plan_args.items())
    if _recorded is not None:
        _recorded.setdefault(kernel, set()).add(key)
    _within_limits(kernel, key, point)


@functools.lru_cache(maxsize=4096)
def _within_limits(kernel: str, key: Tuple[Tuple[str, int], ...],
                   point: Tuple[Tuple[str, int], ...]) -> None:
    from repro_torch.analysis import launch_audit

    found = launch_audit.launch_findings(kernel, dict(key), dict(point))
    if found:
        raise ValueError(f"{kernel} cannot launch at {dict(key + point)}: "
                         + "; ".join(f"{f.rule} {f.message}"
                                     for f in found))


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Sequence[int], device: torch.device,
          contiguous: bool = True) -> None:
    """Raise unless ``t`` has this device, dtype and shape (and is
    contiguous, where asked)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtype_code(t: torch.Tensor, name: str) -> int:
    """The csrc dtype code of ``t``; raises for a type the kernels lack."""
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"float32 or bfloat16") from None


def has_16_byte_rows(t: torch.Tensor) -> bool:
    """Whether every row (last dimension) of ``t`` is contiguous and starts
    16-byte aligned, as ``cp.async`` copies of 16-byte rows need: a
    contiguous last dimension, an aligned base pointer, and strides of the
    other dimensions that are multiples of 16 bytes (a dimension of size 1
    never uses its stride)."""
    per_16 = max(1, 16 // t.element_size())
    return ((t.ndim == 0 or t.shape[-1] <= 1 or t.stride(-1) == 1)
            and t.data_ptr() % 16 == 0
            and not any(st % per_16 for st, n in
                        zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def require_16_byte_rows(t: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` unless :func:`has_16_byte_rows` holds for
    ``t``."""
    if not has_16_byte_rows(t):
        raise ValueError(
            f"{name} (strides {t.stride()}, address {t.data_ptr():#x}) does "
            f"not start every row on 16 bytes, which the kernel's cp.async "
            f"copies need; pass an aligned tensor")


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's plain version for ``t``: on a
    CPU tensor (the tests' path) and on a ``meta`` tensor (shape-only
    evaluation: the dry-run and the cost counter; nothing is launched).
    A CUDA tensor launches the kernel or raises."""
    return t.device.type in ("cpu", "meta")


def run_plain(kernel: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, the plain version of ``kernel``, through
    the ``run_plain`` method of the innermost active dispatch mode that has
    one: a cost count (``repro_torch.launch.graph_analysis.CostCounter``)
    bills the plain version as the kernel itself, one fused op whose
    inputs are read once and outputs written once."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        hook = getattr(mode, "run_plain", None)
        if hook is not None:
            return hook(kernel, fn, args, kwargs)
    return fn(*args, **kwargs)


def partitioned(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a piece of plain torch that no kernel
    takes (or a layer loop's block, ``name`` ``"layer"``), through the
    ``run_partitioned`` method of the innermost active dispatch mode that
    has one: a cost count over ``DTensor``s runs it partitioned as XLA's
    partitioner would (``launch/graph_analysis.py``), where ``DTensor``'s
    own choices vary between torch versions."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        hook = getattr(mode, "run_partitioned", None)
        if hook is not None:
            return hook(name, fn, args, kwargs)
    return fn(*args, **kwargs)


@contextlib.contextmanager
def time_loop(steps: int) -> Iterator[int]:
    """The trips an eager time loop of ``steps`` steps runs: all of them,
    except under a cost count (a dispatch mode with a ``trips`` method,
    ``repro_torch.launch.graph_analysis.CostCounter``), which runs one trip
    and bills it ``steps`` times, as XLA's cost analysis weights a scan's
    body by its known trip count. Every trip of such a loop dispatches the
    same ops at the same shapes, so the one trip bills what all would."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        trips = getattr(mode, "trips", None)
        if trips is not None:
            with trips(steps):
                yield 1
            return
    yield steps


def require_cuda(t: torch.Tensor, kernel: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda, not {t.device}")


def launcher(kernel: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of ``csrc/<kernel>.cu``, typed."""
    fn = getattr(build.load(kernel), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def run(kernel: str, fn, device: torch.device, *args) -> None:
    """Call ``fn(*args, stream)`` on the current stream of ``device`` and
    raise on a non-zero CUDA error. The stream handle is the raw one that
    ``torch.cuda.current_stream`` wraps (building that ``Stream`` object
    costs more host time than the launch itself), and the device becomes
    current for the call only where it is not already."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
