"""The JAX package's outputs for the collectives checks, on 8 virtual CPU
devices, for the port's tests (``tests/test_torch_comms*.py``):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_comms_reference.py INPUTS.npz OUTPUTS.npz

INPUTS holds the global inputs of ``repro_torch.comms.checks.check_inputs(8)``
and the pick sweeps; OUTPUTS gets each check's global output by the name the
port's ``run_checks`` gives its slot.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.5
    from jax.sharding import AxisType
except ImportError:  # older jax: meshes are implicitly "auto"
    AxisType = None

from repro.comms import (
    all_gather_axis,
    allreduce,
    allreduce_flat,
    allreduce_hierarchical,
    allreduce_ring,
    alltoall,
    alltoall_direct,
    alltoall_hierarchical,
    auto_allreduce_strategy,
    auto_alltoall_strategy,
    halo_exchange,
    reduce_scatter,
    ring_shift,
)
from repro.comms.overlap import chunked_collective
from repro.compat import shard_map
from repro.optim.compress import compressed_allreduce, quantize_int8


def mesh2(a, b, names):
    if AxisType is None:
        return jax.make_mesh((a, b), names)
    return jax.make_mesh((a, b), names, axis_types=(AxisType.Auto,) * 2)


def main(src: str, dst: str) -> None:
    assert len(jax.devices()) == 8, jax.devices()
    inp = dict(np.load(src))
    j = {k: jnp.asarray(v) for k, v in inp.items() if v.dtype == np.float32}
    dp = ("pod", "data")
    mesh = mesh2(2, 4, dp)
    ring = mesh2(1, 8, dp)
    x, xr, xc, xe = j["x"], j["xr"], j["xc"], j["xe"]
    out = {
        "allreduce_flat": allreduce_flat(x, mesh, dp),
        "allreduce_hierarchical": allreduce_hierarchical(x, mesh, "pod", ("data",)),
        "allreduce_auto": allreduce(x, mesh, strategy="auto"),
        "allreduce_ring": allreduce_ring(xr, ring, "data"),
        "allreduce_ring_padded": allreduce_ring(j["halo"], ring, "data"),
        "reduce_scatter": reduce_scatter(xr, ring, "data"),
        "ring_shift": ring_shift(xr, ring, "data", 1),
        "ring_shift_3": ring_shift(xr, ring, "data", 3),
        "halo_exchange": halo_exchange(j["halo"], ring, "data", 2),
        "all_gather_axis": all_gather_axis(xr, ring, "data", dim=0),
        "all_gather_axis_dim1": all_gather_axis(xr, ring, "data", dim=1),
        "compressed_allreduce": compressed_allreduce(xc, mesh, "pod", ("data",)),
        "compressed_exact": compressed_allreduce(xe, mesh, "pod", ("data",)),
        "chunked_collective": chunked_collective(lambda p: allreduce_flat(p, mesh, dp), x, 2),
        "alltoall_auto": alltoall(j["blocks"], mesh, dp, strategy="auto"),
    }

    def rs_quantize(v):  # the reduce-scatter and quantize of compressed_allreduce
        shard = jax.lax.psum_scatter(v[0], "data", scatter_dimension=0, tiled=True)
        q, s = quantize_int8(shard)
        return q[None], s[None]

    q, s = shard_map(rs_quantize, mesh=mesh, in_specs=P(dp, None),
                     out_specs=(P(dp, None, None), P(dp, None)), check_vma=False)(xe)
    out["compressed_exact_q"], out["compressed_exact_s"] = q, s
    for o, i in ((2, 4), (4, 2)):
        m = mesh2(o, i, ("outer", "inner"))
        out[f"alltoall_direct_{o}x{i}"] = alltoall_direct(j["blocks"], m, ("outer", "inner"))
        out[f"alltoall_hierarchical_{o}x{i}"] = alltoall_hierarchical(
            j["blocks"], m, "outer", "inner")
    zeros = lambda shape: np.broadcast_to(np.float32(0), shape)  # noqa: E731
    out["auto_allreduce_picks"] = np.array(
        [auto_allreduce_strategy(zeros((8, n)), mesh) for n in inp["allreduce_pick_elems"]])
    out["auto_alltoall_picks"] = np.array(
        [auto_alltoall_strategy(zeros((8, 8, n)), mesh, dp) for n in inp["alltoall_pick_elems"]])
    np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
    print("REFERENCE_OK", len(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
