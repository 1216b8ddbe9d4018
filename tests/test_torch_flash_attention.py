"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's ``ops.attention`` takes the plain version
(``ref.attention_ref``); both are held against the Pallas kernel run in
interpret mode on the JAX package's own cases, at the tolerances the JAX
package uses for itself: 2e-5 for f32, 3e-2 for bf16.  The CUDA kernel runs
only on the card (``test_torch_cuda.py``); here the tests check that it
refuses CPU tensors and that its build refuses to run without nvcc.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# tests/test_kernels.py::FA_CASES — (B, H, G, S, dh, dtype, kwargs)
FA_CASES = [
    (1, 2, 2, 128, 64, "float32", {}),
    (2, 4, 2, 256, 64, "float32", {"window": 64}),
    (1, 8, 1, 128, 128, "float32", {}),  # MQA
    (2, 2, 2, 192, 64, "float32", {"causal": False}),
    (1, 2, 2, 256, 64, "bfloat16", {}),
    (1, 2, 2, 128, 64, "float32", {"softcap": 20.0}),
    (1, 2, 2, 128, 64, "float32", {"window": 32, "softcap": 10.0}),
]


def _inputs(B, H, G, Sq, Sk, dh, dtype, seed=0):
    """The same numpy draws as JAX arrays and torch tensors (kernel layout)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, Sq, dh), (B, G, Sk, dh), (B, G, Sk, dh))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _check_port(tx, want, dtype, **kw):
    """ref.attention_ref and the model-layout ops.attention against ``want``."""
    tol = TOL[dtype]
    q, k, v = tx
    got = attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    got_ops = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    np.testing.assert_allclose(
        got_ops.transpose(1, 2).float().numpy(), want, atol=tol, rtol=tol
    )


@pytest.mark.parametrize("B,H,G,S,dh,dtype,kw", FA_CASES)
def test_flash_attention_vs_pallas(B, H, G, S, dh, dtype, kw):
    (jq, jk, jv), tx = _inputs(B, H, G, S, S, dh, dtype)
    want = pallas_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    _check_port(tx, np.asarray(want, np.float32), dtype, **kw)


def test_flash_attention_q_offset_tail_vs_pallas():
    """Query block from the middle of the sequence (chunked prefill)."""
    S, tail = 256, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 2, S, S, 64, "float32")
    want = pallas_flash(jq[:, :, -tail:], jk, jv, q_offset=S - tail,
                        block_q=32, block_k=64, interpret=True)
    _check_port((tq[:, :, -tail:].contiguous(), tk, tv), np.asarray(want),
                "float32", q_offset=S - tail)


def test_flash_attention_ragged_vs_jax_ref():
    """S=200 is no multiple of the port's 64-row tile (nor of the Pallas
    block, which is why the JAX package routes it to its plain version)."""
    (jq, jk, jv), tx = _inputs(2, 4, 2, 200, 200, 64, "float32", seed=1)
    _check_port(tx, np.asarray(jax_attention_ref(jq, jk, jv)), "float32")


def _attention_p_bf16(q, k, v, *, causal=True, window=0, softcap=0.0):
    """attention_ref with the CUDA bf16 kernel's one extra rounding: the
    unnormalised probabilities enter the PV product in bf16, while the
    softmax denominator sums them in f32.  A model of that rounding only (one
    row max, not the kernel's tiles); nothing on the main path uses it."""
    B, H, S, dh = q.shape
    G = k.shape[1]
    qg = q.reshape(B, G, H // G, S, dh).float()
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * dh**-0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S)
    ok = torch.ones((S, S), dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~ok, NEG_INF)
    m = torch.clamp(s.amax(-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    pv = torch.einsum("bgrst,bgtd->bgrsd", p.to(torch.bfloat16).float(), v.float())
    out = pv / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.reshape(B, H, S, dh).to(q.dtype)


@pytest.mark.parametrize("B,H,G,S,dh,kw", [
    (1, 2, 2, 128, 64, {}),
    (1, 2, 2, 128, 64, {"window": 32}),
    (1, 2, 2, 128, 64, {"softcap": 20.0}),
    (1, 2, 2, 128, 64, {"causal": False}),
    (1, 4, 1, 128, 256, {}),
    (1, 4, 1, 128, 256, {"window": 48}),
    (1, 4, 1, 128, 256, {"window": 48, "softcap": 10.0}),
])
def test_bf16_p_rounding_within_card_tolerance(B, H, G, S, dh, kw):
    """The CUDA bf16 kernel rounds P to bf16 before P V, where the Pallas
    kernel keeps it in f32.  Held against the Pallas kernel in interpret mode
    at the 1e-2 that the card holds the kernel to (against attention_ref),
    this shows that the tolerance covers that rounding."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, G, S, S, dh, "bfloat16", seed=2)
    want = np.asarray(pallas_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw),
                      np.float32)
    got = _attention_p_bf16(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_ops_routes_cpu_tensors_to_plain_version():
    _, (q, k, v) = _inputs(1, 2, 1, 8, 8, 32, "float32")
    before = ops.plain_calls
    ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert ops.plain_calls == before + 1


def test_kernel_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(1, 2, 1, 8, 8, 32, "float32")
    before = kernel.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.flash_attention(q, k, v)
    assert kernel.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["flash_attention"])


def test_build_sources_and_library_name():
    srcs = build.sources("flash_attention")
    assert [s.name for s in srcs] == ["flash_attention.cu"]
    lib = build.library_path("flash_attention")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libflash_attention-")
