"""ctypes wrapper of the hand-written CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``: bf16 runs on
the tensor cores (``wgmma``, fed by TMA), float32 on the CUDA cores.  This
wrapper checks what the kernel takes, allocates the output, launches on
PyTorch's current stream and raises on a launch error.  It never computes
anything itself: a tensor off the card is an error here (``ops.attention``
routes CPU tensors to the plain version).
With grad mode on, an input that requires grad is refused
(``config.refuse_grad``): the kernel has no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.config import refuse_grad

SUPPORTED_DH = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# strides in elements: 16 bytes, as TMA needs for bf16 and float4 loads for f32
_STRIDE_ALIGN = {torch.float32: 4, torch.bfloat16: 8}
_MAX_Q_TILES = 65535  # grid.y of the launch, one 64-row q tile each

# one per kernel launch (not per call that raised before launching)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported (float32, bfloat16)")
    align = _STRIDE_ALIGN[q.dtype]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel needs a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, got {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention: {name} strides {t.stride()} must be multiples of {align} "
                "elements (16 bytes) with a contiguous last axis"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    B, H, Sq, dh = q.shape
    if dh not in SUPPORTED_DH:
        raise ValueError(f"flash_attention: head dim {dh} not in {SUPPORTED_DH}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    G, Sk = k.shape[1], k.shape[2]
    if G == 0 or H % G:
        raise ValueError(f"flash_attention: {H} query heads over {G} kv heads")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError(f"flash_attention: empty input q {tuple(q.shape)}, k {tuple(k.shape)}")
    if -(-Sq // 64) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention: Sq={Sq} exceeds {64 * _MAX_Q_TILES}")


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, dh)
    k: torch.Tensor,  # (B, G, Sk, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """GQA attention forward on the card; returns (B, H, Sq, dh) in q's dtype
    with q's memory layout (so a transposed model-layout view stays one)."""
    global launches
    refuse_grad("flash_attention", q=q, k=k, v=v)
    _check(q, k, v)
    B, H, Sq, dh = q.shape
    G, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)  # q's strides when q is dense, else contiguous
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, H, G, Sq, Sk, dh, strides,
            int(bool(causal)), int(window), int(q_offset),
            float(softcap), float(dh**-0.5), stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return o
