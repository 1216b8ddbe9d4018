"""The decode-attention kernel's plain version and its dispatch, on the CPU.

``ops.decode_attention`` sends CPU tensors to ``ref.decode_attention_ref``,
which must be the port's dense decode path (``models/attention.py``:
``_split_groups``, ``_mask_bias``, ``_attend_dense``) bit for bit, so that
``decode_attention`` with kernels on equals it with kernels off exactly.  The
CUDA kernel runs only on the card (``test_torch_cuda.py``); here the tests
check the split of the cache that its wrapper picks from the shapes, that it
refuses CPU tensors, and that it is built with the others.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import build, use_kernels
from repro_torch.kernels.decode_attention import kernel, ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import attention as attn

torch.set_num_threads(1)

# (label, H, G, dh, cap, pos, window, softcap, dtype): a padded cache holds
# positions 0 .. pos - 1 in their slots and -1 above them; a ring (window ==
# cap) holds the cap - 1 positions before pos at slot position % cap
CASES = [
    ("mha_dh64_unwritten", 4, 4, 64, 48, 20, 0, 0.0, "float32"),
    ("gqa_dh128_full", 8, 2, 128, 40, 39, 0, 0.0, "float32"),
    ("mqa_dh256", 4, 1, 256, 33, 10, 0, 0.0, "float32"),
    ("pos_0", 4, 2, 64, 16, 0, 0, 0.0, "float32"),
    ("pos_cap_minus_1_gqa", 6, 2, 64, 24, 23, 0, 0.0, "float32"),
    ("ring_unwrapped", 4, 2, 64, 16, 9, 16, 0.0, "float32"),
    ("ring_wrapped", 4, 2, 64, 16, 37, 16, 0.0, "float32"),
    ("window_in_padded_cache", 4, 2, 128, 40, 30, 8, 0.0, "float32"),
    ("softcap", 8, 4, 128, 32, 25, 0, 5.0, "float32"),
    ("softcap_ring_wrapped_dh256", 4, 2, 256, 8, 21, 8, 10.0, "float32"),
    ("bf16_gqa_unwritten", 8, 2, 128, 40, 17, 0, 0.0, "bfloat16"),
    ("bf16_ring_wrapped_softcap", 4, 1, 64, 16, 40, 16, 50.0, "bfloat16"),
]


def _cfg(H, G, dh, window, softcap, dtype):
    return dataclasses.replace(smoke_config("llama3.2-1b"), d_model=64, n_heads=H, n_kv_heads=G,
                               head_dim=dh, window=window, attn_softcap=softcap, dtype=dtype)


def _cache(rng, B, G, dh, cap, pos, window, dtype):
    """A cache as decode finds it before writing ``pos``: K/V drawn for every
    written slot, zeros and position -1 in the others."""
    held = range(max(0, pos - cap + 1), pos) if window else range(min(pos, cap))
    slots = [p % cap if window else p for p in held]
    k = torch.zeros((B, cap, G, dh))
    v = torch.zeros((B, cap, G, dh))
    k_pos = torch.full((cap,), -1, dtype=torch.int32)
    for s, p in zip(slots, held):
        k[:, s] = torch.from_numpy(rng.standard_normal((B, G, dh), dtype=np.float32))
        v[:, s] = torch.from_numpy(rng.standard_normal((B, G, dh), dtype=np.float32))
        k_pos[s] = p
    dt = getattr(torch, dtype)
    return {"k": k.to(dt), "v": v.to(dt), "pos": k_pos}


@pytest.mark.parametrize("label,H,G,dh,cap,pos,window,softcap,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_version_is_the_dense_decode_path(label, H, G, dh, cap, pos, window, softcap,
                                                dtype):
    """(1) ``ops`` takes the plain version for CPU tensors and counts it;
    (2) the plain version equals ``_split_groups`` + ``_mask_bias`` +
    ``_attend_dense`` on the same cache bit for bit; (3) ``decode_attention``
    with kernels on equals it with kernels off exactly: output, K/V and
    positions written."""
    B = 2
    rng = np.random.default_rng(len(label))
    cfg = _cfg(H, G, dh, window, softcap, dtype)
    dt = getattr(torch, dtype)
    cache = _cache(rng, B, G, dh, cap, pos, window, dtype)
    # (1), (2) on the cache with pos written
    slot = pos % cap if window else min(pos, cap - 1)
    full = {key: t.clone() for key, t in cache.items()}
    full["k"][:, slot] = torch.from_numpy(rng.standard_normal((B, G, dh), dtype=np.float32)).to(dt)
    full["v"][:, slot] = torch.from_numpy(rng.standard_normal((B, G, dh), dtype=np.float32)).to(dt)
    full["pos"][slot] = pos
    q = torch.from_numpy(rng.standard_normal((B, H, dh), dtype=np.float32)).to(dt)
    p_t = torch.tensor(pos, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, scale=dh**-0.5)
    before = ops.plain_calls
    got = ops.decode_attention(q, full["k"], full["v"], full["pos"], p_t, **kw)
    assert ops.plain_calls == before + 1
    assert got.shape == (B, H, dh) and got.dtype == dt
    bias = attn._mask_bias(p_t.view(1), full["pos"], window, causal=True)
    want = attn._attend_dense(cfg, attn._split_groups(q[:, None], G), full["k"], full["v"], bias)
    assert torch.equal(got, want.reshape(B, H, dh))
    assert torch.equal(decode_attention_ref(q, full["k"], full["v"], full["pos"], p_t, **kw), got)

    # (3) the layer, kernels on against off, from copies of the same cache
    p = attn.attn_params(cfg, torch.Generator().manual_seed(len(label)))
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)).to(dt)
    outs = []
    for on in (False, True):
        c = {key: t.clone() for key, t in cache.items()}
        use_kernels(on)
        try:
            before = ops.plain_calls
            out, c = attn.decode_attention(cfg, p, x, pos, c, window=window)
            assert ops.plain_calls == before + on
        finally:
            use_kernels(False)
        outs.append((out, c))
    (off, c_off), (on_, c_on) = outs
    assert torch.equal(on_, off)
    for key in ("k", "v", "pos"):
        assert torch.equal(c_on[key], c_off[key])


# sms: an H100 SXM's 132 multiprocessors, an H100 PCIe's 114
@pytest.mark.parametrize("B,G,cap,dh,el,sms,want", [
    (64, 16, 1280, 128, 2, 132, (1, 1280)),  # olmo-1b's chat batch: 1024 blocks fill the card
    (8, 8, 2064, 128, 2, 132, (9, 256)),  # mixtral's long prompts: 64 blocks, split
    (8, 8, 2064, 128, 2, 114, (8, 288)),  # the same on fewer multiprocessors: fewer splits
    (1, 1, 70000, 128, 2, 132, (438, 160)),  # one long sequence: blocks to fill the card
    (1, 1, 40000, 256, 4, 132, (500, 80)),
    (4, 2, 30, 32, 4, 132, (1, 64)),  # a cache of one tile
])
def test_split_is_picked_from_the_shapes(B, G, cap, dh, el, sms, want):
    """Splits cover the cache in whole tiles, none empty, each at least
    MIN_TILES tiles where the cache has them and at most MAX_TILES."""
    n, per = kernel.splits(B, G, cap, dh, el, sms)
    assert (n, per) == want
    bt = kernel.tile_keys(dh, el)
    assert per % bt == 0 and (n - 1) * per < cap <= n * per
    assert per // bt <= kernel.MAX_TILES
    assert n == 1 or per // bt >= min(kernel.MIN_TILES, -(-cap // bt))


def test_kernel_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 64))
    k = torch.zeros((1, 8, 2, 64))
    before = kernel.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        kernel.decode_attention(q, k, k, torch.zeros(8, dtype=torch.int32),
                                torch.tensor(3, dtype=torch.int32), scale=0.125)
    assert kernel.launches == before


def test_built_with_the_other_kernels():
    assert "decode_attention" in build.KERNELS
    assert [s.name for s in build.sources("decode_attention")] == ["decode_attention.cu"]
