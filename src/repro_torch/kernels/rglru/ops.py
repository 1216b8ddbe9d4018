"""Model-layout entry point: the RG-LRU scan kernel on the card, the plain
version on the CPU.

There is no fallback between the two: a CUDA tensor goes to the kernel (which
raises on what it does not take), a CPU tensor to ``rglru_ref``.  The kernel
masks a ragged S and W itself, so unlike the JAX package no shape is routed
to the plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_ref

# calls served by the plain version (CPU tensors)
plain_calls = 0


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h = 0 over (B, S, W); h in a's dtype."""
    global plain_calls
    if a.device.type == "cpu":
        plain_calls += 1
        return rglru_ref(a, b)[0]
    return rglru_scan(a, b)
