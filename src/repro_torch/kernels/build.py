"""Build the CUDA kernels with nvcc and load them through ctypes.

Each kernel lives in ``kernels/<name>/csrc/*.cu`` behind a plain C
interface.  Its sources compile with one nvcc call into
``BUILD_DIR/lib<name>-<hash>.so``, where the hash covers the sources and the
flags, so an edited source builds anew and an unchanged one loads at once.
``build()`` starts the nvcc calls of all kernels together and waits for all.
The build happens at first use.  There is no fallback: without nvcc, or
when nvcc fails, the call raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from repro_torch.kernels.config import BUILD_DIR

KERNELS_DIR = Path(__file__).resolve().parent
KERNELS = ("flash_attention", "rwkv6", "rglru", "decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources(name: str) -> list:
    srcs = sorted((KERNELS_DIR / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {KERNELS_DIR / name / 'csrc'}")
    return srcs


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted((KERNELS_DIR / name / "csrc").glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels cannot be built"
    )


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, all at once
    (one nvcc process each).  Returns the wall seconds from the start of the
    builds to the end of each kernel's (0.0 when the library was already
    there); raises if a build fails, after every nvcc has exited."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds, jobs, running = {}, {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources(name))]
        jobs[name] = (cmd, tmp, out, out.with_suffix(".log"))
    t0 = time.perf_counter()
    for name, (cmd, tmp, out, log) in jobs.items():
        with open(log, "w") as f:
            running[name] = (subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in running.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"kernel build failed: {name} (nvcc exit {rc}):\n{log.read_text()}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas registers,
    shared memory and spills), or '' when it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
