"""Kernel dispatch switch, default device and build directory.

``use_kernels(True)`` routes the model's hot spots through the hand-written
CUDA kernels (in prefill: flash attention for ATTN and LOCAL layers, the
WKV6 scan for RWKV layers and the RG-LRU scan for RGLRU layers; in decode,
self-attention over the KV cache through the decode-attention kernel); the
default False keeps the plain PyTorch path, as ``repro.kernels.use_pallas``
does for the JAX package.
With kernels on, a tensor on the CPU takes the kernel's plain PyTorch version
and a CUDA tensor takes the kernel; nothing falls back from one to the other.
"""
from __future__ import annotations

from pathlib import Path

import torch

DEFAULT_DEVICE = "cuda"

# nvcc output (shared libraries keyed by a hash of their sources); listed in
# .gitignore and made at first use
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_USE_KERNELS = False


def use_kernels(on: bool) -> None:
    global _USE_KERNELS
    _USE_KERNELS = bool(on)


def kernels_enabled() -> bool:
    return _USE_KERNELS


def refuse_grad(kernel: str, **inputs: torch.Tensor) -> None:
    """Raise where autograd would need a gradient through ``kernel``: its
    wrapper fills its outputs outside autograd, so they would carry no
    ``grad_fn`` and ``backward`` would drop every gradient through the layer
    without an error."""
    if not torch.is_grad_enabled():
        return
    needing = [name for name, t in inputs.items() if t.requires_grad]
    if needing:
        raise RuntimeError(
            f"{kernel}: {', '.join(needing)} require grad, but the CUDA kernel has no backward; "
            "the reference's Pallas kernels have no VJP either, and training runs the plain "
            "path with kernels off (use_kernels(False)) or under torch.no_grad()")
