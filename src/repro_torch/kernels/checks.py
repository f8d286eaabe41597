"""Argument checks and launch plumbing shared by the kernels' wrappers."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

# The dtype code every csrc launcher takes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    raise on a non-zero CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
