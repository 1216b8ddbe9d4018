"""Benchmark of the PyTorch/CUDA port of the repository (src/repro_torch)."""
