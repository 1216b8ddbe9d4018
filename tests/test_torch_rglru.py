"""The port's RG-LRU scan against the JAX package's Pallas kernel and oracle.

On the CPU the port's ``ops.scan`` takes the plain version (``ref.rglru_ref``,
the sequential recurrence); it is held against the Pallas kernel run in
interpret mode and against JAX's own ``rglru_ref`` on the JAX package's
kernel cases, at the JAX package's own tolerances for its kernel: f32 atol
1e-5 / rtol 1e-4, bf16 atol 0.15 / rtol 0.1.  Ragged lengths, which the
Pallas kernel does not take, and a carried h0 are held against JAX's
``rglru_ref``.  The CUDA kernel runs only on the card
(``test_torch_cuda.py``); here the tests check that it refuses CPU tensors,
how it cuts S into chunks, and that it is built with the others.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.rglru import ops as jax_ops
from repro.kernels.rglru.kernel import rglru_scan as pallas_rglru_scan
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref
from repro_torch.kernels import build
from repro_torch.kernels.rglru import kernel, ops
from repro_torch.kernels.rglru.ref import rglru_ref

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
TOL_BF16 = dict(atol=0.15, rtol=0.1)

# tests/test_kernels.py::test_rglru_vs_ref — (B, S, W, chunk, block_w)
RGLRU_CASES = [
    (1, 128, 128, 64, 128),
    (2, 256, 256, 128, 128),
    (1, 64, 512, 32, 256),
]


def _inputs(B, S, W, seed=0, lo=0.3, hi=0.999, dtype=np.float32):
    """a uniform in [lo, hi), b standard normal, as tests/test_kernels.py
    draws them (numpy), as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W), dtype=np.float32)
    if dtype == ml_dtypes.bfloat16:
        a, b = (x.astype(dtype) for x in (a, b))
        return [jnp.asarray(x) for x in (a, b)], [
            torch.from_numpy(x.astype(np.float32)).bfloat16() for x in (a, b)]
    return [jnp.asarray(x) for x in (a, b)], [torch.from_numpy(x) for x in (a, b)]


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("B,S,W,chunk,bw", RGLRU_CASES)
def test_rglru_ref_vs_pallas_and_jax_ref(B, S, W, chunk, bw):
    (ja, jb), (ta, tb) = _inputs(B, S, W)
    y, h_fin = rglru_ref(ta, tb)
    assert y.dtype == torch.float32 and h_fin.shape == (B, W)
    py = pallas_rglru_scan(ja, jb, chunk=chunk, block_w=bw, interpret=True)
    ry, rfin = jax_rglru_ref(ja, jb)
    _close(y, py)
    _close(y, ry)
    _close(h_fin, rfin)
    _close(ops.scan(ta, tb), py)


def test_rglru_bf16_vs_pallas():
    """tests/test_kernels.py::test_rglru_bf16: bf16 in and out, f32 carry."""
    (ja, jb), (ta, tb) = _inputs(1, 128, 128, seed=1, lo=0.5, hi=0.99, dtype=ml_dtypes.bfloat16)
    y, _ = rglru_ref(ta, tb)
    assert y.dtype == torch.bfloat16
    _close(y, pallas_rglru_scan(ja, jb, chunk=64, interpret=True), **TOL_BF16)
    # the two plain versions compute the same f32 recurrence on the same bits
    _close(y, jax_rglru_ref(ja, jb)[0], atol=0, rtol=1e-2)


@pytest.mark.parametrize("S", [70, 200])
def test_rglru_ragged_lengths_vs_jax(S):
    """S no multiple of the Pallas kernel's chunk of 128: the JAX package's
    ``ops.scan`` takes its oracle; the port's plain version agrees."""
    (ja, jb), (ta, tb) = _inputs(2, S, 96, seed=S)
    want = jax_ops.scan(ja, jb)
    _close(ops.scan(ta, tb), want)
    _close(rglru_ref(ta, tb)[1], jax_rglru_ref(ja, jb)[1])


def test_rglru_ref_carries_h0():
    (ja, jb), (ta, tb) = _inputs(2, 24, 64, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 64), dtype=np.float32)
    y, fin = rglru_ref(ta, tb, torch.from_numpy(h0))
    ry, rfin = jax_rglru_ref(ja, jb, jnp.asarray(h0))
    _close(y, ry)
    _close(fin, rfin)


def test_ops_routes_cpu_tensors_to_plain_version():
    _, (ta, tb) = _inputs(1, 8, 32)
    before = ops.plain_calls
    y = ops.scan(ta, tb)
    assert ops.plain_calls == before + 1
    assert torch.equal(y, rglru_ref(ta, tb)[0])


def test_kernel_refuses_cpu_tensors():
    _, (ta, tb) = _inputs(1, 8, 32)
    before = kernel.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.rglru_scan(ta, tb)
    assert kernel.launches == before


@pytest.mark.parametrize("S", [1, 31, 32, 33, 200, 512, 513, 2560, 8192])
def test_chunking_covers_the_sequence(S):
    """Chunks are whole multiples of the 32 steps a thread holds, at most 16
    of them, and the last one is not empty."""
    L, C = kernel.chunking(S)
    assert L % kernel.SUB == 0 and 1 <= C <= kernel.MAX_CHUNKS
    assert (C - 1) * L < S <= C * L
    if S <= kernel.SUB * kernel.MAX_CHUNKS:
        assert L == kernel.SUB  # the shortest chunk while 16 of them suffice


def test_build_sources_and_library_name():
    assert "rglru" in build.KERNELS
    assert [s.name for s in build.sources("rglru")] == ["rglru_scan.cu"]
    lib = build.library_path("rglru")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("librglru-")
