"""Griffin / RecurrentGemma RG-LRU recurrent block.

Ported from ``repro.models.griffin``.  Block wiring (Griffin,
arXiv:2402.19427):

    gate  = GeLU(W_gate x)                      (d -> W)
    u     = causal_conv1d(W_in x, width=4)      (d -> W, depthwise conv)
    h     = RG-LRU(u)                           (W -> W, diagonal recurrence)
    out   = W_out (gate * h)                    (W -> d)

RG-LRU recurrence (c = 8):

    r_t = sigmoid(BlockDiag_a(u_t))             recurrence gate
    i_t = sigmoid(BlockDiag_x(u_t))             input gate
    a_t = exp(-c * softplus(Lambda) * r_t)      data-dependent diag decay
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full-sequence scan goes through ``_scan_dispatch``: the hand-written
CUDA kernel (``repro_torch.kernels.rglru``) with kernels on, else log-depth
doubling passes, the counterpart of the JAX package's
``lax.associative_scan``.  Both ``rglru_block`` and ``rglru_block_prefill``
take their h from it; the JAX package's prefill calls ``associative_scan``
directly and reaches its Pallas kernel only through ``rglru_block``.  Decode
is the single-step form and updates the cache in place.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.config import kernels_enabled
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.models.common import dense_init, dtype_of

N_BLOCKS = 8
C_RGLRU = 8.0


def lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_params(cfg: ModelConfig, gen: torch.Generator, lead: Tuple[int, ...] = ()) -> dict:
    """The JAX package's keys, shapes and dtypes (the gates and Lambda in f32,
    the matrices and the conv in the model dtype); ``lead`` prepends
    stacking axes (a layer group's count)."""
    d, W = cfg.d_model, lru_width(cfg)
    dt = dtype_of(cfg)
    bw = W // N_BLOCKS
    # Lambda init so a^c spans ~(0.9, 0.999) as in the paper
    lam = torch.linspace(2.0, 6.0, W, dtype=torch.float32, device=gen.device)
    return {
        "w_gate": dense_init(gen, lead + (d, W), dt, fan_in=d),
        "w_in": dense_init(gen, lead + (d, W), dt, fan_in=d),
        "conv_w": dense_init(gen, lead + (cfg.conv_width, W), dt, fan_in=cfg.conv_width),
        "conv_b": torch.zeros(lead + (W,), dtype=dt, device=gen.device),
        "gate_a": dense_init(gen, lead + (N_BLOCKS, bw, bw), torch.float32, fan_in=bw),
        "gate_x": dense_init(gen, lead + (N_BLOCKS, bw, bw), torch.float32, fan_in=bw),
        "lam": lam.expand(lead + (W,)).clone(),
        "w_out": dense_init(gen, lead + (W, d), dt, fan_in=W),
    }


def _block_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: x (..., W) @ blockdiag(w (N, bw, bw))."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (N_BLOCKS, shape[-1] // N_BLOCKS))
    yb = torch.einsum("...nw,nwk->...nk", xb, w)
    return yb.reshape(shape)


def _gates(p: dict, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, gated input), both f32, for u (..., W)."""
    uf = u.float()
    r = torch.sigmoid(_block_linear(p["gate_a"], uf))
    i = torch.sigmoid(_block_linear(p["gate_x"], uf))
    log_a = -C_RGLRU * F.softplus(p["lam"]) * r  # (<= 0)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1: 1 - exp(2 log_a)
    b_scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    gated_in = b_scale * i * uf
    return a, gated_in


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h = 0, in log2(S) passes
    that each compose every affine map with the one 2^k steps before it
    (the Pallas kernel's in-chunk scan over the whole sequence)."""
    A, H = a, b
    S, s = a.shape[1], 1
    while s < S:
        H = torch.cat([H[:, :s], A[:, s:] * H[:, :-s] + H[:, s:]], dim=1)
        A = torch.cat([A[:, :s], A[:, s:] * A[:, :-s]], dim=1)
        s *= 2
    return H


def _scan_dispatch(a: torch.Tensor, gin: torch.Tensor) -> torch.Tensor:
    """The kernel's entry point when kernels are on (``use_kernels``): the
    CUDA kernel on the card for every shape, its plain version (the
    sequential recurrence) on the CPU.  Otherwise the log-depth doubling
    scan, as the JAX package takes ``lax.associative_scan``."""
    if kernels_enabled():
        return lru_ops.scan(a, gin)
    return _doubling_scan(a, gin)


def rglru_scan(p: dict, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU.  u: (B, S, W) -> h: (B, S, W)."""
    a, gin = _gates(p, u)  # (B, S, W) f32
    return _scan_dispatch(a, gin).to(u.dtype)


def rglru_step(p: dict, u: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step.  u: (B, W); h: (B, W) f32 carried state."""
    a, gin = _gates(p, u)
    h_new = a * h + gin
    return h_new.to(u.dtype), h_new


def causal_conv(p: dict, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width cfg.conv_width.  u: (B, S, W).  Taps are
    summed in the JAX package's order (tap width-1-i for i from 0), so that
    bf16 rounds where it rounds there."""
    width = p["conv_w"].shape[0]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = sum(pad[:, i : i + S] * p["conv_w"][width - 1 - i][None, None] for i in range(width))
    return out + p["conv_b"][None, None]


def causal_conv_step(p: dict, u: torch.Tensor, conv_state: torch.Tensor):
    """u: (B, W) new input; conv_state: (B, width-1, W) previous inputs.
    Returns (output (B, W), the next conv state, a view of a new tensor)."""
    window = torch.cat([conv_state, u[:, None]], dim=1)  # (B, width, W)
    # window is ordered oldest -> newest; conv_w[j] weights the input j steps
    # back, so the newest entry takes conv_w[0]: flip the taps.
    out = torch.einsum("bwd,wd->bd", window, torch.flip(p["conv_w"], [0])) + p["conv_b"][None]
    return out, window[:, 1:]


# --------------------------------------------------------------------------
# Full block.
# --------------------------------------------------------------------------

def rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence recurrent block.  x: (B, S, d)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u = causal_conv(p, x @ p["w_in"])
    h = rglru_scan(p, u)
    return (gate * h) @ p["w_out"]


def rglru_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Full-sequence block that also returns the decode cache: h's last row in
    f32 and the last width-1 inputs of the conv (zeros in front when the
    sequence is shorter)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u_raw = x @ p["w_in"]
    u = causal_conv(p, u_raw)
    a, gin = _gates(p, u)
    hh = _scan_dispatch(a, gin)
    h = hh.to(u.dtype)
    width = cfg.conv_width
    conv_tail = u_raw[:, -(width - 1):]
    S = u_raw.shape[1]
    if S < width - 1:  # pad front with zeros (cold conv state)
        conv_tail = F.pad(conv_tail, (0, 0, width - 1 - S, 0))
    cache = {"h": hh[:, -1].float(), "conv": conv_tail}
    return (gate * h) @ p["w_out"], cache


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    W = lru_width(cfg)
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=dtype_of(cfg), device=device),
    }


def rglru_block_decode(
    cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict
) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d) -> (y, cache).  Unlike the JAX package, which returns a
    new cache, this writes the new h and conv state into ``cache`` in place
    and returns the same dict."""
    xt = x[:, 0]
    gate = F.gelu(xt @ p["w_gate"], approximate="tanh")
    u_raw = xt @ p["w_in"]
    u, conv_state = causal_conv_step(p, u_raw, cache["conv"])
    h_out, h_state = rglru_step(p, u, cache["h"])
    y = ((gate * h_out) @ p["w_out"])[:, None]
    cache["h"].copy_(h_state)
    cache["conv"].copy_(conv_state)
    return y, cache
