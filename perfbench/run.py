"""Entry point of the benchmark of the PyTorch/CUDA port (``src/repro_torch``):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The set-up time counts from the start of
this script.  Every build and kernel cache goes to fixed directories inside
the checkout; the port's own kernel builds go to its ``kernels/_build``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no program under test at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        sys.exit(2)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness

    sys.exit(harness.main(t_start=T_START))
