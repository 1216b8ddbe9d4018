"""ctypes wrapper of the hand-written CUDA WKV6 kernel.

The kernel (``csrc/wkv6.cu``) replaces the Pallas TPU kernel
``repro/kernels/rwkv6/kernel.py::wkv6``.  Its entry point launches two CUDA
kernels, a chunk-parallel pass and the state chain, with f32 scratch in
device memory between them.  This wrapper checks what the kernel takes,
allocates y, the final state and the scratch, launches on PyTorch's current
stream and raises on a launch error.  It never computes anything itself: a
tensor off the card is an error here (``ops.wkv`` routes CPU tensors to the
plain version).
With grad mode on, an input that requires grad is refused
(``config.refuse_grad``): the kernel has no backward.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.config import refuse_grad

SUPPORTED_K = (32, 64)
SUPPORTED_CHUNK = (16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# one per call that launched the kernels (not per call that raised before
# launching)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("rwkv6")
        fn = lib.wkv6_fwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.wkv6_error_string)
    return _fn


def _check(r, k, v, log_w, u, chunk: int) -> None:
    named = (("r", r), ("k", k), ("v", v), ("log_w", log_w), ("u", u))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6: {name} is on {t.device}, the kernel needs a CUDA tensor")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r on {r.device}")
    if r.dtype not in _DTYPES:
        raise ValueError(f"wkv6: r dtype {r.dtype} not supported (float32, bfloat16)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise ValueError(f"wkv6: {name} is {t.dtype}, r is {r.dtype}")
    for name, t in (("log_w", log_w), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"wkv6: {name} must be float32, got {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, K), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    for name, t in named[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(t.shape)} differs from r {tuple(r.shape)}")
    if u.shape != (H, K) or not u.is_contiguous():
        raise ValueError(f"wkv6: u must be a contiguous ({H}, {K}), got {tuple(u.shape)}")
    for name, t in named[:4]:
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(
                f"wkv6: {name} strides {t.stride()} must be multiples of 4 "
                "elements with a contiguous last axis"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} is not 16-byte aligned")
    if K not in SUPPORTED_K:
        raise ValueError(f"wkv6: head size {K} not in {SUPPORTED_K}")
    if chunk not in SUPPORTED_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} not in {SUPPORTED_CHUNK}")
    if B == 0 or S == 0 or H == 0:
        raise ValueError(f"wkv6: empty input {tuple(r.shape)}")


def wkv6(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,  # (B, S, H, K) f32
    u: torch.Tensor,  # (H, K) f32
    *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over the whole sequence from a zero state, on the card.  Returns
    y (B, S, H, K) in r's dtype and the final state (B, H, K, K) in f32.
    Any S: a partial last chunk is handled in the kernel."""
    global launches
    refuse_grad("wkv6", r=r, k=k, v=v, log_w=log_w, u=u)
    _check(r, k, v, log_w, u, chunk)
    B, S, H, K = r.shape
    y = torch.empty((B, S, H, K), dtype=r.dtype, device=r.device)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    # scratch between the two kernels: att, r exp(cum_ex), k exp(cum_L - cum)
    # and exp(cum_L) of every chunk
    nc = -(-S // chunk)
    f32 = dict(dtype=torch.float32, device=r.device)
    att = torch.empty((B, H, nc, chunk, chunk), **f32)
    rd = torch.empty((B, H, nc * chunk, K), **f32)
    kd = torch.empty((B, H, nc * chunk, K), **f32)
    dec = torch.empty((B, H, nc, K), **f32)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, log_w, y) for s in (t.stride(0), t.stride(1), t.stride(2)))
    )
    fn, err_str = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
            y.data_ptr(), state.data_ptr(), att.data_ptr(), rd.data_ptr(), kd.data_ptr(),
            dec.data_ptr(), _DTYPES[r.dtype], B, S, H, K, int(chunk),
            strides, stream,
        )
    if err:
        raise RuntimeError(f"wkv6 launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y, state
