"""The products every reference runs, shared so that each model is judged
in the same precision and against the same control: float32 with TF32 off
(``set_precision``, ``f32_linear``), and the control's float8 e4m3
(``fp8_linear``).  A reference takes one of the two as its ``linear``."""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest float8 e4m3 value


def f32_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) f32 @ w (k, n), w cast to f32."""
    return x @ w.float()


def _fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: the activations rounded to float8 e4m3 a row
    at a time, the weight a column at a time, then multiplied in f32."""
    return _fp8_round(x.float(), -1) @ _fp8_round(w.float(), 0)


def set_precision() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
