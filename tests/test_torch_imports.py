"""The port stands alone: importing ``repro_torch`` and every submodule loads
neither JAX nor any module of the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
import torch.distributed as dist
world = dist.is_available() and dist.is_initialized()  # importing starts no world
print(len(names), "modules;", "loaded:", bad, "world:", world)
sys.exit(1 if bad or world or len(names) < 10 else 0)
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_no_jax_and_no_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


DISTRIBUTION = ["repro_torch.comms.allreduce", "repro_torch.comms.alltoall",
                "repro_torch.comms.allgather", "repro_torch.comms.p2p",
                "repro_torch.comms.overlap", "repro_torch.optim.compress",
                "repro_torch.launch.mesh", "repro_torch.sharding.specs",
                "repro_torch.sharding.tp", "repro_torch.sharding.checks", "repro_torch.sharding.__init__",
                "repro_torch.runtime.fault", "repro_torch.runtime.elastic",
                "repro_torch.runtime.checks", "repro_torch.launch.dryrun",
                "repro_torch.launch.hlo_analysis"]


def test_distribution_modules_are_in_the_port():
    """The collectives, compression, the mesh helpers, the collective timer,
    the sharding rules, the split compute's operators, the recovery modules,
    the dry-run and the cost counter are port modules, so the two tests
    above walk them."""
    for name in DISTRIBUTION:
        assert (SRC / (name.replace(".", "/") + ".py")).is_file(), name
    assert "def bench_allreduce(" in (PORT / "core" / "benchmark.py").read_text()


KERNELS = ["repro_torch.kernels.decode_attention.cases",
           "repro_torch.kernels.decode_attention.kernel",
           "repro_torch.kernels.decode_attention.ops",
           "repro_torch.kernels.decode_attention.ref"]


def test_kernel_modules_are_in_the_port():
    """The decode-attention kernel's wrapper, dispatch, plain version and cases are
    port modules, so the two tests above walk them; its CUDA source sits
    beside them."""
    for name in KERNELS:
        assert (SRC / (name.replace(".", "/") + ".py")).is_file(), name
    assert (PORT / "kernels" / "decode_attention" / "csrc" / "decode_attention.cu").is_file()
