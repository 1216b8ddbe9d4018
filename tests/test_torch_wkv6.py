"""The port's WKV6 against the JAX package's Pallas kernel and oracle.

On the CPU the port's ``ops.wkv`` takes the plain version (``ref.wkv6_ref``,
the token-by-token recurrence); it is held against the Pallas kernel run in
interpret mode and against JAX's own ``wkv6_ref`` on the JAX package's kernel
cases plus its strong-decay case, at the JAX package's own tolerance for its
kernel, 2e-4.  ``ref.wkv6_split_ref``, the CUDA kernel's two passes
(chunk-parallel att, rd, kd and dec from compensated cumulative sums, then
the state chain over slices of V) in plain PyTorch, is held against the same
references and against the recurrence at a ragged length and at the model's
clipped decay draw.  The port's ``wkv_chunked`` (the plain chunked scan of
``models/rwkv.py``) is held against JAX's at a ragged length.  The CUDA
kernel runs only on the card (``test_torch_cuda.py``); here the tests check
that it refuses CPU tensors and that the kernels build in parallel.
"""
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv as jrwkv
from repro.kernels.rwkv6.kernel import wkv6 as pallas_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import kernel, ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref, wkv6_split_ref
from repro_torch.models import rwkv as trwkv

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)

# tests/test_kernels.py::WKV_CASES — (B, S, H, K, chunk)
WKV_CASES = [
    (1, 64, 2, 64, 16),
    (2, 128, 3, 64, 32),
    (1, 96, 1, 32, 32),
]


def _inputs(B, S, H, K, seed=0, log_w=None):
    """r, k, v, log_w, u drawn as tests/test_kernels.py draws them (numpy),
    as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, K), dtype=np.float32)
    k = rng.standard_normal((B, S, H, K), dtype=np.float32) * 0.5
    v = rng.standard_normal((B, S, H, K), dtype=np.float32)
    if log_w is None:
        log_w = -np.exp(rng.standard_normal((B, S, H, K), dtype=np.float32))
    u = rng.standard_normal((H, K), dtype=np.float32) * 0.1
    arrs = (r, k, v, np.asarray(log_w, np.float32), u)
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("B,S,H,K,chunk", WKV_CASES)
def test_wkv6_ref_vs_pallas_and_jax_ref(B, S, H, K, chunk):
    jx, tx = _inputs(B, S, H, K)
    y, fin = wkv6_ref(*tx)
    assert y.dtype == torch.float32 and fin.shape == (B, H, K, K)
    py, pfin = pallas_wkv6(*jx, chunk=chunk, interpret=True)
    ry, rfin = jax_wkv6_ref(*jx)
    for want_y, want_fin in ((py, pfin), (ry, rfin)):
        _close(y, want_y)
        _close(fin, want_fin)


@pytest.mark.parametrize("B,S,H,K,chunk", WKV_CASES)
def test_wkv6_split_ref_vs_pallas_and_jax_ref(B, S, H, K, chunk):
    jx, tx = _inputs(B, S, H, K)
    y, fin = wkv6_split_ref(*tx, chunk=chunk)
    assert y.dtype == torch.float32 and fin.shape == (B, H, K, K)
    py, pfin = pallas_wkv6(*jx, chunk=chunk, interpret=True)
    ry, rfin = jax_wkv6_ref(*jx)
    for want_y, want_fin in ((py, pfin), (ry, rfin)):
        _close(y, want_y)
        _close(fin, want_fin)


def _clipped_log_w(B, S, H, K, seed):
    """-exp(clip(-1 + 4 z, -8, 8)), z standard normal: the model's decay with
    both clips reached (steps of -e^8 = -2981 beside steps of -3.4e-4), as
    chip_smoke.py draws it."""
    z = np.random.default_rng(seed).standard_normal((B, S, H, K), dtype=np.float32)
    return -np.exp(np.clip(-1.0 + 4.0 * z, -8.0, 8.0))


@pytest.mark.parametrize("S,chunk,clipped", [(70, 32, False), (256, 32, True)])
def test_wkv6_split_ref_vs_recurrence(S, chunk, clipped):
    """A ragged S (70: the last chunk holds 6 rows) and the clipped draw, at
    B=2 H=4 K=64.  At the clipped draw the plain chunked algebra with f32
    cumulative sums (``wkv_chunked``, the Pallas body's) misses the
    tolerance: the compensated sums are what keep the split within it."""
    B, H, K = 2, 4, 64
    log_w = _clipped_log_w(B, S, H, K, seed=5) if clipped else None
    _, tx = _inputs(B, S, H, K, seed=6, log_w=log_w)
    y, fin = wkv6_split_ref(*tx, chunk=chunk)
    ry, rfin = wkv6_ref(*tx)
    _close(y, ry)
    _close(fin, rfin)
    if clipped:
        cy, _ = trwkv.wkv_chunked(*tx, chunk=chunk)
        assert (cy - ry).abs().max().item() > TOL["atol"]


def test_wkv6_ref_strong_decay_stable():
    """w = e^-50 at every step (tests/test_kernels.py's strong-decay case)."""
    B, S, H, K = 1, 64, 1, 32
    jx, tx = _inputs(B, S, H, K, seed=1, log_w=np.full((B, S, H, K), -50.0))
    jx[4], tx[4] = jnp.zeros((H, K)), torch.zeros(H, K)
    y, fin = wkv6_ref(*tx)
    assert bool(torch.isfinite(y).all())
    py, _ = pallas_wkv6(*jx, chunk=16, interpret=True)
    ry, rfin = jax_wkv6_ref(*jx)
    _close(y, py, atol=1e-4)
    _close(y, ry, atol=1e-4)
    _close(fin, rfin)


def test_wkv6_ref_carries_state0():
    jx, tx = _inputs(2, 24, 2, 32, seed=2)
    s0 = np.random.default_rng(3).standard_normal((2, 2, 32, 32), dtype=np.float32)
    y, fin = wkv6_ref(*tx, state0=torch.from_numpy(s0))
    ry, rfin = jax_wkv6_ref(*jx, state0=jnp.asarray(s0))
    _close(y, ry)
    _close(fin, rfin)


def test_wkv_chunked_ragged_vs_jax():
    """S=70 is no multiple of the chunk: both pad the last chunk."""
    jx, tx = _inputs(2, 70, 2, 16, seed=4)
    y, fin = trwkv.wkv_chunked(*tx, chunk=32)
    jy, jfin = jrwkv.wkv_chunked(*jx, chunk=32)
    _close(y, jy)
    _close(fin, jfin)
    ry, rfin = trwkv.wkv_recurrent(*tx)
    jry, jrfin = jrwkv.wkv_recurrent(*jx)
    _close(ry, jry)
    _close(rfin, jrfin)


def test_ops_routes_cpu_tensors_to_plain_version():
    _, tx = _inputs(1, 8, 1, 32)
    before = ops.plain_calls
    y, fin = ops.wkv(*tx, chunk=32)
    assert ops.plain_calls == before + 1
    ry, rfin = wkv6_ref(*tx)
    assert torch.equal(y, ry) and torch.equal(fin, rfin)


def test_kernel_refuses_cpu_tensors():
    _, tx = _inputs(1, 8, 1, 32)
    before = kernel.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.wkv6(*tx)
    assert kernel.launches == before


def test_build_sources_and_library_name():
    assert "rwkv6" in build.KERNELS
    assert [s.name for s in build.sources("rwkv6")] == ["wkv6.cu"]
    lib = build.library_path("rwkv6")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("librwkv6-")


def _fake_nvcc(path, body: str) -> str:
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_starts_every_kernel_and_reports_failures(monkeypatch, tmp_path):
    """All nvcc processes run at once: each fake nvcc waits until every
    kernel's has started, so one after another would never finish."""
    started = tmp_path / "started"
    started.mkdir()
    n = len(build.KERNELS)
    ok = _fake_nvcc(tmp_path / "nvcc_ok", f"""
touch "{started}/$$"
i=0
while [ "$(ls "{started}" | wc -l)" -lt {n} ] && [ $i -lt 300 ]; do sleep 0.02; i=$((i+1)); done
[ "$(ls "{started}" | wc -l)" -ge {n} ] || exit 3
while [ "$1" != "-o" ]; do shift; done
touch "$2"
""")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: ok)
    seconds = build.build()
    assert sorted(seconds) == sorted(build.KERNELS)
    assert all(build.library_path(name).exists() for name in build.KERNELS)
    assert build.build() == {name: 0.0 for name in build.KERNELS}  # built: loads at once

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build2")
    bad = _fake_nvcc(tmp_path / "nvcc_bad", 'echo "error: no such arch"; exit 2\n')
    monkeypatch.setattr(build, "nvcc", lambda: bad)
    with pytest.raises(RuntimeError, match=r"kernel build failed: flash_attention[\s\S]*"
                                           r"kernel build failed: rwkv6"):
        build.build()
    assert not any((tmp_path / "build2").glob("*.so"))
