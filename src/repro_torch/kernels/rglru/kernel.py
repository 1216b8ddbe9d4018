"""ctypes wrapper of the hand-written CUDA RG-LRU scan kernel.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/rglru/kernel.py::rglru_scan``.  This wrapper checks what the
kernel takes, picks the chunking of S, allocates y and the kernel's f32
workspace of chunk summaries, launches on PyTorch's current stream and
raises on a launch error.  It never computes anything itself: a tensor off
the card is an error here (``ops.scan`` routes CPU tensors to the plain
version).
With grad mode on, an input that requires grad is refused
(``config.refuse_grad``): the kernel has no backward.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.config import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUB = 32  # steps a thread holds in registers; a chunk is a multiple of it
MAX_CHUNKS = 16

# one per kernel launch (not per call that raised before launching)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("rglru")
        fn = lib.rglru_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.rglru_error_string)
    return _fn


def chunking(S: int) -> Tuple[int, int]:
    """(chunk length L, number of chunks C) for a sequence of S steps: L the
    smallest multiple of SUB that cuts S into at most MAX_CHUNKS chunks."""
    subs = -(-S // SUB)
    L = -(-subs // MAX_CHUNKS) * SUB
    return L, -(-S // L)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"rglru_scan: {name} is on {t.device}, the kernel needs a CUDA tensor")
    if b.device != a.device:
        raise ValueError(f"rglru_scan: b is on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"rglru_scan: a dtype {a.dtype} not supported (float32, bfloat16)")
    if b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: b is {b.dtype}, a is {a.dtype}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b must be one (B, S, W) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.numel() == 0:
        raise ValueError(f"rglru_scan: empty input {tuple(a.shape)}")
    if a.shape[0] > 65535:
        raise ValueError(f"rglru_scan: batch {a.shape[0]} above 65535")
    for name, t in (("a", a), ("b", b)):
        if t.stride(-1) != 1:
            raise ValueError(f"rglru_scan: {name} strides {t.stride()} need a contiguous last axis")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h = 0, per channel of (B, S, W), on the
    card.  Returns every h_t in a's dtype; the carry is f32.  Any S and W:
    ragged edges are masked in the kernel."""
    global launches
    refuse_grad("rglru_scan", a=a, b=b)
    _check(a, b)
    B, S, W = a.shape
    L, C = chunking(S)
    y = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    workspace = torch.empty((2, B, C - 1, W), dtype=torch.float32, device=a.device)
    fn, err_str = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), y.data_ptr(), workspace.data_ptr() or None,
            _DTYPES[a.dtype], B, S, W, L, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            stream,
        )
    if err:
        raise RuntimeError(f"rglru_scan launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y
