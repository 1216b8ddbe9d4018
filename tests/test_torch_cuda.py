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
from repro_torch.kernels.rglru import kernel as lru_kernel
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import decode as dec
from repro_torch.models import griffin, moe
from repro_torch.models.convert import draw_xattn_gates, tree_map
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
    # the wgmma kernel (bf16): every head dim, ragged lengths, a binding
    # window at dh=256, softcap, q_offset with Sq < Sk (S = (Sq, Sk)), one KV
    # head under 16 query heads, no causal mask
    (2, 4, 2, 200, 32, torch.bfloat16, {}),
    (2, 4, 2, 333, 64, torch.bfloat16, {}),
    (2, 8, 2, 200, 128, torch.bfloat16, {}),
    (1, 4, 2, 333, 256, torch.bfloat16, {"window": 64}),
    (1, 2, 2, 128, 64, torch.bfloat16, {"softcap": 20.0}),
    (1, 2, 2, 200, 256, torch.bfloat16, {"window": 32, "softcap": 10.0}),
    (2, 4, 1, (37, 301), 64, torch.bfloat16, {"q_offset": 264}),
    (1, 16, 1, (100, 612), 256, torch.bfloat16, {"q_offset": 512, "window": 256}),
    (2, 16, 1, 256, 64, torch.bfloat16, {}),
    (2, 2, 2, 192, 128, torch.bfloat16, {"causal": False}),
    # gemma2's prefill: 16 query heads over 8 KV heads of 256, softcap 50 on
    # every layer, window 4096 on the LOCAL ones (binding at 256 here)
    (4, 16, 8, 512, 256, torch.bfloat16, {"softcap": 50.0}),
    (4, 16, 8, 512, 256, torch.bfloat16, {"softcap": 50.0, "window": 4096}),
    (1, 16, 8, 700, 256, torch.bfloat16, {"softcap": 50.0, "window": 256}),
    (1, 16, 8, 300, 256, torch.float32, {"softcap": 50.0, "window": 64}),
    # whisper's encoder: 1500 frames, no causal mask, a 92-row last tile;
    # and the f32 (CUDA-core) route non-causal at a ragged length
    (4, 12, 12, 1500, 64, torch.bfloat16, {"causal": False}),
    (1, 4, 4, 1100, 64, torch.float32, {"causal": False}),
    # mixtral's and dbrx's prefill: 48 query heads over 8 KV heads of 128, a
    # group of 6 (the first on a path that is not a power of two)
    (4, 48, 8, 512, 128, torch.bfloat16, {}),
    (1, 48, 8, 300, 128, torch.float32, {}),
    (1, 48, 8, 700, 128, torch.bfloat16, {"window": 256}),
])
def test_kernel_matches_plain_version(cuda_device, B, H, G, S, dh, dtype, kw):
    """f32 at 1e-4: the kernel sums in another order than the plain version;
    bf16 at 1e-2, above the rounding of bf16 outputs and of the kernel's bf16
    P (test_torch_flash_attention.py holds that rounding to the Pallas kernel
    on the CPU)."""
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device, dtype)
               for s in ((B, Sq, H, dh), (B, Sk, G, dh), (B, Sk, G, dh)))
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


def test_kernel_bf16_strided_view_matches_plain_version(cuda_device):
    """q, k, v cut from wider rows (strides of 2 dh, multiples of 8): TMA
    reads the views in place; o comes back dense."""
    rng = np.random.default_rng(1)
    B, S, H, G, dh = 2, 160, 4, 2, 64

    def view(heads):
        wide = torch.from_numpy(rng.standard_normal((B, S, heads, 2 * dh), dtype=np.float32))
        return wide.to(cuda_device, torch.bfloat16)[..., :dh]

    q, k, v = view(H), view(G), view(G)
    out = ops.attention(q, k, v, window=48)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=48)
    torch.testing.assert_close(out.transpose(1, 2).float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype,step", [(torch.bfloat16, 4), (torch.float32, 2)])
def test_kernel_rejects_strides_off_16_bytes(cuda_device, dtype, step):
    """TMA (bf16) needs strides of 16 bytes, 8 elements; the f32 kernel's
    float4 loads 16 bytes too, 4 elements."""
    wide = torch.zeros(1, 64, 2, 64 + step, device=cuda_device, dtype=dtype)
    q = wide[..., :64].transpose(1, 2)  # sequence stride 2 (64 + step) elements
    before = kernel.launches
    with pytest.raises(ValueError, match="multiples of"):
        kernel.flash_attention(q, q, q)
    assert kernel.launches == before


def _wkv_inputs(device, B, S, H, K, dtype, log_w_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)

    def mk(scale=1.0):
        return torch.from_numpy(rng.standard_normal((B, S, H, K), dtype=np.float32) * scale).to(device)

    r, k, v = mk().to(dtype), mk(0.5).to(dtype), mk().to(dtype)
    log_w = -torch.exp(torch.clamp(-1.0 + mk(log_w_scale), -8.0, 8.0))
    u = torch.from_numpy(rng.standard_normal((H, K), dtype=np.float32) * 0.1).to(device)
    return r, k, v, log_w, u


@pytest.mark.parametrize("B,S,H,K,chunk,dtype,log_w_scale", [
    (1, 64, 2, 64, 16, torch.float32, 1.0),
    (2, 128, 3, 64, 32, torch.float32, 1.0),
    (1, 96, 1, 32, 32, torch.float32, 1.0),
    (2, 70, 2, 64, 32, torch.float32, 1.0),  # ragged: a partial last chunk
    (2, 256, 4, 64, 32, torch.float32, 4.0),  # steps down to the clip, -e^8
    (2, 200, 4, 64, 32, torch.bfloat16, 1.0),
    (1, 20, 2, 64, 32, torch.float32, 1.0),  # S below one chunk
    (2, 97, 3, 32, 32, torch.bfloat16, 1.0),  # a last chunk of one row
])
def test_wkv6_kernel_matches_plain_version(cuda_device, B, S, H, K, chunk, dtype, log_w_scale):
    """f32 at 2e-4, the JAX package's tolerance for its kernel against the
    recurrence; bf16 y at 1e-2, above one rounding of a bf16 output (the
    state stays f32)."""
    r, k, v, log_w, u = _wkv_inputs(cuda_device, B, S, H, K, dtype, log_w_scale)
    before = wkv_kernel.launches
    y, state = wkv_ops.wkv(r, k, v, log_w, u, chunk=chunk)
    assert wkv_kernel.launches == before + 1
    y_ref, state_ref = wkv6_ref(r, k, v, log_w, u)
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    assert y.dtype == dtype and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=2e-4, rtol=2e-4)


def test_wkv6_kernel_takes_a_strided_log_w(cuda_device):
    """log_w as the transposed view of a (B, H, S, K) buffer: one launch (the
    entry point's two CUDA kernels count as one), and the recurrence's
    result."""
    r, k, v, log_w, u = _wkv_inputs(cuda_device, 2, 96, 4, 64, torch.float32, 4.0)
    log_w = log_w.transpose(1, 2).contiguous().transpose(1, 2)
    assert not log_w.is_contiguous()
    before = wkv_kernel.launches
    y, state = wkv_kernel.wkv6(r, k, v, log_w, u)
    assert wkv_kernel.launches == before + 1
    y_ref, state_ref = wkv6_ref(r, k, v, log_w, u)
    torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, state_ref, atol=2e-4, rtol=2e-4)


def test_wkv6_kernel_rejects_bf16_log_w(cuda_device):
    r, k, v, log_w, u = _wkv_inputs(cuda_device, 1, 32, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="log_w must be float32"):
        wkv_kernel.wkv6(r, k, v, log_w.bfloat16(), u)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b"])
def test_smoke_prefill_on_card_matches_cpu_rwkv(cuda_device, arch):
    """The WKV6 kernel launches once per layer; the prompt of 40 ends in a
    partial chunk; the state cache agrees too."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 40)))
    use_kernels(True)
    try:
        before = wkv_kernel.launches
        want, want_cache = dec.prefill(cfg, params, tokens)
        got, got_cache = dec.prefill(cfg, tree_map(lambda t: t.to(cuda_device), params),
                                     tokens.to(cuda_device))
        assert wkv_kernel.launches == before + cfg.n_layers
    finally:
        use_kernels(False)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_cache[0][0]["state"].cpu(), want_cache[0][0]["state"],
                               atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("B,S,W,dtype,draw", [
    (1, 128, 128, torch.float32, "uniform"),
    (2, 256, 256, torch.float32, "uniform"),
    (1, 64, 512, torch.float32, "uniform"),
    (2, 200, 96, torch.float32, "uniform"),  # ragged S and W
    (1, 70, 4100, torch.float32, "uniform"),  # W past a multiple of the tile
    (1, 2560, 256, torch.float32, "uniform"),  # chunks of 160 steps
    (1, 128, 128, torch.bfloat16, "uniform"),
    (2, 300, 128, torch.float32, "model"),  # a from the model's gates
])
def test_rglru_kernel_matches_plain_version(cuda_device, B, S, W, dtype, draw):
    """The JAX package's tolerances for its kernel: f32 atol 1e-5 / rtol
    1e-4, bf16 atol 0.15 / rtol 0.1."""
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal((B, S, W), dtype=np.float32)).to(cuda_device)
    if draw == "uniform":
        a = torch.from_numpy(rng.uniform(0.3, 0.999, (B, S, W)).astype(np.float32)).to(cuda_device)
    else:
        W8 = W // griffin.N_BLOCKS
        p = {"gate_a": torch.randn(8, W8, W8, device=cuda_device) / W8 ** 0.5,
             "gate_x": torch.randn(8, W8, W8, device=cuda_device) / W8 ** 0.5,
             "lam": torch.linspace(2.0, 6.0, W, device=cuda_device)}
        a, b = griffin._gates(p, b)
    a, b = a.to(dtype), b.to(dtype)
    before = lru_kernel.launches
    y = lru_ops.scan(a, b)
    assert lru_kernel.launches == before + 1
    want, _ = rglru_ref(a, b)
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.15, rtol=0.1)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), want.float(), **tol)


def test_rglru_kernel_rejects_mixed_dtypes(cuda_device):
    a = torch.rand(1, 8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="b is torch.bfloat16"):
        lru_kernel.rglru_scan(a, a.bfloat16())


def test_smoke_prefill_on_card_matches_cpu_recurrentgemma(cuda_device):
    """A prompt of 40 over the smoke window of 32 binds the window in the
    flash kernel and makes each LOCAL layer's cache a ring; each LOCAL layer
    launches the flash kernel once and each RGLRU layer the RG-LRU kernel
    once; logits and every cache agree."""
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"), dtype="float32")
    kinds = [k for g in cfg.groups for k in g.pattern * g.count]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 40)))
    use_kernels(True)
    try:
        before = (kernel.launches, lru_kernel.launches)
        want, want_cache = dec.prefill(cfg, params, tokens, capacity=48)
        got, got_cache = dec.prefill(cfg, tree_map(lambda t: t.to(cuda_device), params),
                                     tokens.to(cuda_device), capacity=48)
        assert (kernel.launches - before[0], lru_kernel.launches - before[1]) == (
            kinds.count("local"), kinds.count("rglru"))
    finally:
        use_kernels(False)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for g, w in zip(got_cache, want_cache):
        for gd, wd in zip(g, w):
            for key in wd:
                torch.testing.assert_close(gd[key].cpu(), wd[key], atol=1e-4, rtol=1e-4)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_layer_on_card_matches_cpu(cuda_device, arch):
    """The dense MoE layer in f32 at smoke width: output and aux loss on the
    card against the CPU at 1e-4 (the products sum in another order), the
    same experts picked."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    p = moe.moe_params(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, cfg.d_model),
                                                                  dtype=np.float32))
    want, want_aux = moe.moe_apply_dense(cfg, p, x)
    got, got_aux = moe.moe_apply_dense(cfg, tree_map(lambda t: t.to(cuda_device), p),
                                       x.to(cuda_device))
    _, want_idx, _ = moe._route(cfg, p["router"], x.reshape(-1, cfg.d_model))
    _, got_idx, _ = moe._route(cfg, p["router"].to(cuda_device),
                               x.to(cuda_device).reshape(-1, cfg.d_model))
    assert torch.equal(got_idx.cpu(), want_idx)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b", "recurrentgemma-9b", "olmo-1b",
                                  "codeqwen1.5-7b", "gemma2-9b", "whisper-small",
                                  "llama-3.2-vision-11b", "mixtral-8x22b", "dbrx-132b"])
def test_decode_graph_replay_matches_eager(cuda_device, arch):
    """Smoke width in f32: the captured step replayed against the same steps
    run eagerly on the card from a copy of the same caches; logits at each
    step, the greedy tokens and every cache leaf at 1e-4.  A prompt of 40
    wraps the smoke window of 32, so the replays write a LOCAL ring at slot
    ``pos % 32`` from the device.  whisper and llama-vision get a frontend
    and XATTN gates in ±[0.3, 1.0) (at their initial zero the layer adds
    nothing); a replayed step reads learned positions, tanh of the gates and
    the cross K/V on the device.  mixtral and dbrx route each token on the
    device (top-k, the gates scattered into a dense combine weight)."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    P, N = 40, 6
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(2, P))).to(cuda_device)
    draw_xattn_gates(params, rng, lambda a: torch.from_numpy(a).to(cuda_device))
    frontend = None
    if cfg.frontend_tokens:
        frontend = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model),
            dtype=np.float32)).to(cuda_device)
    use_kernels(True)
    try:
        logits, caches = dec.prefill(cfg, params, tokens, frontend=frontend, capacity=P + N)
    finally:
        use_kernels(False)
    tok = logits.argmax(-1)[:, None]
    steps = dec.DecodeGraph(cfg, params, _clone(caches), tok, P, N)
    want_toks = []
    for i in range(N):
        want_toks.append(tok[:, 0])
        want, caches = dec.decode_step(cfg, params, caches, tok, P + i)
        got = steps.step().clone()
        assert steps.graph is not None  # step 0 ran eagerly, then was captured
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        tok = want.argmax(-1)[:, None]
    assert torch.equal(steps.tokens, torch.stack(want_toks, dim=1))
    assert int(steps.pos) == P + N
    for g, w in zip(_leaves(steps.caches), _leaves(caches)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_capture_refuses_a_host_read_of_the_position(cuda_device):
    """Writing a cache slot picked by the 0-d position tensor through Python
    indexing reads the position on the host (``.item()``), which a capture
    refuses: the capture raises rather than recording a fixed slot."""
    cache = torch.zeros(2, 8, 4, device=cuda_device)
    pos = torch.tensor(3, dtype=torch.int32, device=cuda_device)
    new = torch.ones(2, 4, device=cuda_device)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=torch.cuda.Stream()):
            cache[:, int(pos)] = new
    torch.cuda.synchronize()


def test_decode_graph_raises_when_the_step_cannot_be_captured(cuda_device, monkeypatch):
    """No eager fallback on the card: a step that reads a device value on the
    host runs as the eager warm-up, then its capture raises."""
    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.zeros((2, 8), dtype=torch.int64, device=cuda_device)
    logits, caches = dec.prefill(cfg, params, tokens, capacity=12)
    eager = dec.decode_step

    def syncing_step(cfg, params, caches, token, pos):
        return eager(cfg, params, caches, token, int(pos))

    monkeypatch.setattr(dec, "decode_step", syncing_step)
    steps = dec.DecodeGraph(cfg, params, caches, logits.argmax(-1)[:, None], 8, 4)
    with pytest.raises(RuntimeError):
        steps.step()
    assert steps.graph is None
    torch.cuda.synchronize()


def _llama_smoke_on(device, batch: int, P: int, N: int):
    """f32 smoke llama3.2-1b drawn on the CPU, then moved: weights, prompts,
    prefill logits and caches on ``device``."""
    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    params = tree_map(lambda t: t.to(device), init_params(cfg, torch.Generator().manual_seed(0)))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(batch, P))).to(device)
    logits, caches = dec.prefill(cfg, params, tokens, capacity=P + N)
    return cfg, params, logits, caches


def test_decode_graph_shed_recaptures_at_the_smaller_batch(cuda_device):
    """A shed between two replays releases the graph; the next step warms up
    and captures again at B-1 (one ``recapture_seconds``), from caches cut
    to new contiguous tensors.  The kept rows equal an unshed run's, the
    shed row keeps its token of the shed step and reads -1 after it."""
    B, P, N, at = 3, 16, 8, 3
    cfg, params, logits, caches = _llama_smoke_on(cuda_device, B, P, N)
    tok = logits.argmax(-1)[:, None]
    unshed = dec.DecodeGraph(cfg, params, _clone(caches), tok, P, N)
    for _ in range(N):
        unshed.step()
    steps = dec.DecodeGraph(cfg, params, caches, tok, P, N)
    for _ in range(at):
        steps.step()
    assert steps.graph is not None and steps.recapture_seconds == []
    steps.shed(dec.cut_caches(cfg, steps.caches, B - 1, P + N))
    assert steps.graph is None and steps.batch == B - 1
    assert all(t.is_contiguous() for t in _leaves(steps.caches))
    for _ in range(at, N):
        steps.step()
    assert steps.graph is not None and len(steps.recapture_seconds) == 1
    got, want = steps.tokens.cpu(), unshed.tokens.cpu()
    assert torch.equal(got[:B - 1], want[:B - 1])
    assert torch.equal(got[B - 1, :at + 1], want[B - 1, :at + 1])
    assert (got[B - 1, at + 1:] == -1).all()


def test_consult_between_replays_keeps_the_cpu_tokens(cuda_device):
    """serve's per-step consult (the plan span, the link probe into the
    health monitor) between replays reads nothing from the device: the
    replayed generations equal the same steps run eagerly on the CPU."""
    from repro_torch import obs
    from repro_torch.comms.autotune import select_allreduce_strategy
    from repro_torch.obs import drift, health, trace

    B, P, N = 2, 16, 10
    gens = []
    for device in ("cpu", cuda_device):
        obs.reset_all()
        obs.metrics.enable()
        cfg, params, logits, caches = _llama_smoke_on(device, B, P, N)
        steps = dec.DecodeGraph(cfg, params, caches, logits.argmax(-1)[:, None], P, N)
        for i in range(N):
            with trace.span("plan"):
                pick = select_allreduce_strategy({"data": 1, "model": 1}, 4096.0 * (P + i + 1))
            drift.record("tpu_v5e", "dcn", "probe", 1e6, 1e-3, (10.0 if i > 3 else 1.0) * 1e-3)
            steps.step()
        gens.append(steps.tokens.cpu())
        assert pick == "flat" and health.monitor().link("tpu_v5e", "dcn").state == "degraded"
        assert obs.metrics.to_json()["histograms"][
            "plan.select_allreduce_strategy.seconds"]["count"] == N
    obs.reset_all()
    assert torch.equal(gens[0], gens[1])


@pytest.mark.parametrize("name", ["flash_attention", "wkv6", "rglru_scan"])
def test_kernel_refuses_inputs_that_require_grad(cuda_device, name):
    """With grad mode on, a CUDA input that requires grad is refused before
    any launch (the kernel has no backward: its output would carry no
    grad_fn); under no_grad the same inputs launch once.  Inputs are drawn
    with numpy: a failed capture earlier in the file leaves torch's CUDA
    generator unusable."""
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.uniform(0.1, 0.9, shape).astype(np.float32)).to(cuda_device)

    fn, module, inputs = {
        "flash_attention": (kernel.flash_attention, kernel, [draw(1, 2, 64, 64) for _ in range(3)]),
        "wkv6": (wkv_kernel.wkv6, wkv_kernel,
                 list(_wkv_inputs(cuda_device, 1, 32, 2, 64, torch.float32))),
        "rglru_scan": (lru_kernel.rglru_scan, lru_kernel, [draw(1, 64, 32) for _ in range(2)]),
    }[name]
    inputs = [t.clone().requires_grad_() for t in inputs]
    before = module.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*inputs)
    assert module.launches == before
    with torch.no_grad():
        fn(*inputs)
    torch.cuda.synchronize()
    assert module.launches == before + 1


def test_host_device_copy_fit_on_card(cuda_device):
    """The paper's §VI measurement on the card: the host -> device copy at the
    reference's sizes, fitted to a postal model with a positive per-byte cost."""
    from repro_torch.core.benchmark import bench_host_device_roundtrip

    res = bench_host_device_roundtrip()
    assert all(np.isfinite(t) and t > 0 for t in res.times)
    assert np.isfinite(res.fitted.alpha) and res.fitted.alpha >= 0
    assert np.isfinite(res.fitted.beta) and res.fitted.beta > 0


def test_fitted_card_registers_and_plans_gpudirect(cuda_device):
    from repro_torch.core import get_machine, plan_messages, registered_machines
    from repro_torch.core.benchmark import bench_host_device_roundtrip, spec_from_measurements

    res = bench_host_device_roundtrip()
    spec = spec_from_measurements("h100_fitted_test", res, injectors_per_node=1)
    assert "h100_fitted_test" in registered_machines()
    assert get_machine("h100_fitted_test") is spec
    plan = plan_messages(spec, 65536.0, 4)
    assert plan.strategy == "gpudirect" and plan.predicted_time > 0
