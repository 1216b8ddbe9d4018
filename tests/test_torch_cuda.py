"""Tests of the port that need an NVIDIA GPU; they skip without one.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (the repository's conftest imports the JAX package):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import use_kernels
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import decode as dec
from repro_torch.models.convert import tree_map
from repro_torch.models.transformer import init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,G,S,dh,dtype,kw", [
    (1, 2, 2, 128, 64, torch.float32, {}),
    (2, 4, 2, 256, 64, torch.float32, {"window": 64}),
    (1, 8, 1, 128, 128, torch.float32, {}),
    (2, 2, 2, 192, 64, torch.float32, {"causal": False}),
    (1, 2, 2, 256, 64, torch.bfloat16, {}),
    (1, 2, 2, 128, 64, torch.float32, {"window": 32, "softcap": 10.0}),
    (2, 4, 2, 200, 32, torch.float32, {}),
    (1, 4, 2, 130, 256, torch.bfloat16, {"window": 40}),
])
def test_kernel_matches_plain_version(cuda_device, B, H, G, S, dh, dtype, kw):
    """f32 at 1e-4: the kernel sums in another order than the plain version;
    bf16 at 1e-2, above the rounding of bf16 outputs."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device, dtype)
               for s in ((B, S, H, dh), (B, S, G, dh), (B, S, G, dh)))
    before = kernel.launches
    out = ops.attention(q, k, v, **kw)
    assert kernel.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.transpose(1, 2).float(), want.float(), atol=tol, rtol=tol)


def test_kernel_rejects_unsupported_head_dim(cuda_device):
    q = torch.zeros(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        kernel.flash_attention(q, q, q)


def test_smoke_prefill_on_card_matches_cpu(cuda_device):
    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 40)))
    use_kernels(True)
    try:
        before = kernel.launches
        want, _ = dec.prefill(cfg, params, tokens)
        got, _ = dec.prefill(cfg, tree_map(lambda t: t.to(cuda_device), params),
                             tokens.to(cuda_device))
        assert kernel.launches == before + cfg.n_layers
    finally:
        use_kernels(False)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
