"""Plain PyTorch references that decide ``correct``.  They import nothing of
the program under test (``repro_torch``) nor of the JAX package (``repro``)
and read only the inputs the benchmark made."""
