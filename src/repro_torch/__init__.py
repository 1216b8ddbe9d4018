"""PyTorch/CUDA port of the ``repro`` JAX package for one NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it and
nothing of JAX.  It keeps the reference's parameter trees and public layouts
so that weights carry across 1:1 (``repro_torch.models.convert``).  Entry
points run on ``cuda`` unless the caller asks for the CPU.
"""
