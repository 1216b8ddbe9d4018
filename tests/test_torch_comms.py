"""The port's collectives (``repro_torch.comms``, ``optim.compress``) on an
8-process gloo world, held rank by rank against the JAX package's outputs on
8 virtual CPU devices, for the checks of ``tests/_multidevice_checks.py``
from the all-reduces to the chunked collective, at their shapes and draw.

One world runs every check (``repro_torch.comms.checks.run_checks``); the
reference runs in a subprocess at the same time, as ``tests/test_comms.py``
runs its own.  Sums taken in another order agree at the reference's 1e-5;
the ring all-reduce (the reference's order, step by step) and every
operation that only moves data agree exactly; compression meets the
reference's bound, and at a draw whose reduce-scatter is exact it gives the
reference's int8s, scales and output.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.comms import checks
from repro_torch.launch.mesh import run_world

HERE = os.path.dirname(__file__)
WORLD = 8
WORLD_TIMEOUT = 300.0

# the port's inner building blocks against the reference's wrappers around its own
REFERENCE_NAME = {"allreduce_flat_inner": "allreduce_flat",
                  "allreduce_hier_inner": "allreduce_hierarchical",
                  "allreduce_ring_inner": "allreduce_ring",
                  "compressed_allreduce_slow_inner": "compressed_allreduce"}
# outputs every rank holds whole (replicated in the reference)
WHOLE = ("all_gather_axis", "all_gather_axis_dim1", "auto_allreduce_picks",
         "auto_alltoall_picks")


def _reference_name(name: str) -> str:
    if name in REFERENCE_NAME:
        return REFERENCE_NAME[name]
    return name.replace("direct_inner", "direct").replace("hier_inner", "hierarchical")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(port: one dict a rank, reference: name -> global output)."""
    tmp = tmp_path_factory.mktemp("comms")
    src, dst = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(src, **checks.check_inputs(WORLD),
             allreduce_pick_elems=np.array(checks.ALLREDUCE_PICK_ELEMS),
             alltoall_pick_elems=np.array(checks.ALLTOALL_PICK_ELEMS))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_comms_reference.py"),
                            str(src), str(dst)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = run_world(checks.run_checks, WORLD, WORLD, device="cpu", timeout=WORLD_TIMEOUT)
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
    return port, dict(np.load(dst))


@pytest.mark.parametrize("name", sorted(checks.hold(WORLD)))
def test_rank_by_rank_against_the_reference(outputs, name):
    """Each rank's slot of every check holds against the reference's global
    output as ``checks.hold`` says: equal, at 1e-5, or within the bound."""
    port, ref = outputs
    want = ref[_reference_name(name)]
    for r in range(WORLD):
        why = checks.disagreement(name, port[r][name], want if name in WHOLE else want[r], WORLD)
        assert not why, f"rank {r}: {why}"


def test_halo_wraps_the_seam(outputs):
    """The halos are the neighbours' edges, rank 0's left halo rank k-1's
    (the reference's cyclic permutations)."""
    port, _ = outputs
    h = checks.check_inputs(WORLD)["halo"]
    for r in range(WORLD):
        want = np.concatenate([h[(r - 1) % WORLD][-2:], h[r], h[(r + 1) % WORLD][:2]])
        np.testing.assert_array_equal(port[r]["halo_exchange"], want)
