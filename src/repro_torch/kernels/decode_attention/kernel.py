"""ctypes wrapper of the hand-written CUDA decode-attention kernel.

The kernel (``csrc/decode_attention.cu``) replaces no TPU kernel: the JAX
package's decode attention is plain jnp.  It attends one query position to a
KV cache, reading each attendable K/V slot once in the cache's own type.
This wrapper checks what the kernel takes, picks the split of the cache's
slots from the shapes and the card's multiprocessors alone (so a captured
step keeps it), allocates the
output and the splits' f32 partials, launches on PyTorch's current stream
and raises on a launch error.  It reads nothing on the host: ``pos`` stays
on the device.  It never computes anything itself: a tensor off the card is
an error here (``ops.decode_attention`` routes CPU tensors to the plain
version).  With grad mode on, an input that requires grad is refused
(``config.refuse_grad``): the kernel has no backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.config import refuse_grad

SUPPORTED_DH = (32, 64, 128, 256)
MAX_GROUP_HEADS = 16  # query heads a KV head may carry (two groups of 8 in a block)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_BYTES = 8192  # K (and V) of one tile: the kernel's TILE_BYTES
MAX_TILES = 1024  # tiles of one split: the kernel's MAX_TILES
MIN_TILES = 4  # tiles a split keeps at least, where the cache has them
BLOCKS_PER_SM = 4  # blocks that fill the card: four a multiprocessor

# one per kernel launch (not per call that raised before launching)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("decode_attention")
        fn = lib.decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


def tile_keys(dh: int, element_size: int) -> int:
    """Cache slots in one of the kernel's tiles: TILE_BYTES of K."""
    return TILE_BYTES // (dh * element_size)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def splits(B: int, G: int, cap: int, dh: int, element_size: int, sms: int) -> Tuple[int, int]:
    """(number of splits, slots a split) of a cache of ``cap`` slots on a
    card of ``sms`` multiprocessors: one where B * G blocks fill the card,
    else as many as BLOCKS_PER_SM * sms blocks ask, each of at least
    MIN_TILES tiles and at most MAX_TILES; a split is a whole number of
    tiles, the last one may be short.  The shapes and the card alone decide
    it, so a captured step keeps it."""
    bt = tile_keys(dh, element_size)
    tiles = -(-cap // bt)
    n = min(-(-BLOCKS_PER_SM * sms // (B * G)), max(1, tiles // MIN_TILES))
    n = max(n, -(-tiles // MAX_TILES))
    per = -(-tiles // n)
    return -(-tiles // per), per * bt


def _check(q, k_cache, v_cache, k_pos, pos) -> None:
    named = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("k_pos", k_pos),
             ("pos", pos))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} is on {t.device}, the kernel needs a "
                             "CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported (float32, bfloat16)")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype}, q is {q.dtype}")
    if k_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"decode_attention: k_pos and pos must be int32, got {k_pos.dtype} "
                         f"and {pos.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q (B, H, dh) and k, v (B, cap, G, dh), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, dh = q.shape
    _, cap, G, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != dh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against cache "
                         f"{tuple(k_cache.shape)}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"decode_attention: head dim {dh} not in {SUPPORTED_DH}")
    if B == 0 or cap == 0 or G == 0 or H % G or H // G > MAX_GROUP_HEADS:
        raise ValueError(f"decode_attention: {H} query heads over {G} KV heads, batch {B}, "
                         f"{cap} slots (a KV head carries 1 to {MAX_GROUP_HEADS})")
    if k_pos.shape != (cap,) or k_pos.stride(0) != 1 or pos.numel() != 1:
        raise ValueError(f"decode_attention: k_pos {tuple(k_pos.shape)} must be a contiguous "
                         f"({cap},), pos one element, got {tuple(pos.shape)}")
    if q.stride(-1) != 1:
        raise ValueError(f"decode_attention: q strides {q.stride()} need a contiguous last axis")
    align = 16 // q.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} strides {t.stride()} must be multiples "
                             f"of {align} elements (16 bytes) with a contiguous last axis, "
                             "from a 16-byte aligned start")


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k_cache: torch.Tensor,  # (B, cap, G, dh)
    v_cache: torch.Tensor,
    k_pos: torch.Tensor,  # (cap,) int32: each slot's position, -1 where unwritten
    pos: torch.Tensor,  # 0-d int32: the query's position
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    """One query position's attention over the cache slots attendable from
    ``pos`` (``0 <= k_pos <= pos``, within ``window`` where it is not 0), on
    the card; returns (B, H, dh) in v's dtype."""
    global launches
    refuse_grad("decode_attention", q=q, k_cache=k_cache, v_cache=v_cache)
    _check(q, k_cache, v_cache, k_pos, pos)
    B, H, dh = q.shape
    _, cap, G, _ = k_cache.shape
    n_split, split_len = splits(B, G, cap, dh, q.element_size(), sm_count(q.device))
    out = torch.empty((B, H, dh), dtype=v_cache.dtype, device=q.device)
    part_o = part_ml = None
    if n_split > 1:
        part_o = torch.empty((B, H, n_split, dh), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k_cache.stride()[:3],
                                      *v_cache.stride()[:3])
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_pos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None,
            _DTYPES[q.dtype], B, H, G, cap, dh, strides, int(window), float(softcap),
            float(scale), n_split, split_len, stream,
        )
    if err:
        raise RuntimeError(f"decode_attention launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return out
