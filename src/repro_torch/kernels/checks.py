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


def require_16_byte_rows(t: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` unless every row (last dimension) of ``t``
    starts 16-byte aligned, as ``cp.async`` copies of 16-byte rows need: an
    aligned base pointer, and strides of the other dimensions that are
    multiples of 16 bytes (a dimension of size 1 never uses its stride)."""
    per_16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % per_16 for st, n in
                                zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(
            f"{name} (strides {t.stride()}, address {t.data_ptr():#x}) does "
            f"not start every row on 16 bytes, which the kernel's cp.async "
            f"copies need; pass an aligned tensor")


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
