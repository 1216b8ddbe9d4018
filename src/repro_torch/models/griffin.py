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

Over the model axis (``sharding.tp``), given the rank's blocks, the block
computes on the rank's W/n channels as the reference's GSPMD splits it:
``w_gate`` and ``w_in`` column-parallel, the conv, Lambda, the gates'
elementwise part and the scan per channel with no collective, ``w_out``
row-parallel and one all-reduce.  The block-diagonal gates run on the
rank's blocks where its channels are whole blocks (n divides the 8 blocks);
where one block spans several ranks (n a multiple of 8) each rank gathers
u's channels once, narrows them to its block's input and applies its
columns of that block (:func:`block_columns`), 1/n of the whole product.
Whole leaves compute whole.  Given also the rank's FSDP blocks over the
data axes (a decode step's ``DistContext.data_split``, :func:`fsdp_split`),
``w_gate`` and ``w_in`` contract over the rank's block of x's channels (one
all-reduce over the data axes of both) and ``w_out`` writes its block of the
output's channels, gathered over them; the conv and Lambda have no FSDP
dim and compute as above, and the gates, which have none either, contract
over the rank's part of each block's input channels over the data axes, as
the reference's GSPMD computes them there (one all-reduce of both).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.config import kernels_enabled
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.sharding import tp

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


def _rows_part(bw: int, part: Tuple[int, int]) -> Tuple[int, int]:
    """(first row, rows) of a block's ``bw`` input channels in part i of n."""
    i, n = part
    if bw % n:
        raise ValueError(f"rec gate: a block's {bw} input channels over {n} data ranks")
    return i * (bw // n), bw // n


def _block_linear(w: torch.Tensor, x: torch.Tensor, part: Tuple[int, int] = (0, 1)
                  ) -> torch.Tensor:
    """Block-diagonal linear: x (..., k·bw) @ blockdiag(w (k, bw, bw)), k the
    N_BLOCKS blocks of the whole leaf or a rank's blocks of it; ``part`` (i,
    n) contracts over part i of n of each block's input channels only (a
    partial sum)."""
    shape = x.shape
    k = w.shape[0]
    xb = x.reshape(shape[:-1] + (k, shape[-1] // k))
    if part[1] > 1:
        at, q = _rows_part(xb.shape[-1], part)
        xb, w = xb.narrow(-1, at, q), w.narrow(1, at, q)
    yb = torch.einsum("...nw,nwk->...nk", xb, w)
    return yb.reshape(shape)


def block_columns(w: torch.Tensor, u: torch.Tensor, r: int, n: int,
                  n_blocks: int = N_BLOCKS, part: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Columns [r·W/n, (r+1)·W/n) of u (..., W) @ blockdiag(w (n_blocks, bw,
    bw)), from the input they need alone: where n divides n_blocks, rank
    r's n_blocks/n blocks on its own channels; where n is a multiple of
    n_blocks, its W/n columns of block r·n_blocks/n on that block's bw
    channels.  Raises on any other n.  ``part`` as :func:`_block_linear`'s."""
    W = u.shape[-1]
    bw, c = W // n_blocks, W // n
    if n_blocks % n == 0:
        k = n_blocks // n
        return _block_linear(w.narrow(0, r * k, k), u.narrow(-1, r * c, c), part)
    if n % n_blocks == 0:
        blk, j = divmod(r, n // n_blocks)
        at, q = _rows_part(bw, part)
        return u.narrow(-1, blk * bw + at, q) @ w[blk].narrow(0, at, q).narrow(-1, j * c, c)
    raise ValueError(f"rec gate: {n_blocks} blocks over a model axis of {n}")


def _gate_products(p: dict, uf: torch.Tensor, split: bool = False, dist=None,
                   n_blocks: int = N_BLOCKS, data: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlockDiag_a(u) and BlockDiag_x(u) of uf (..., W) f32; where ``split``,
    this rank's columns of each from its channels uf (..., W/n): on its
    blocks of ``gate_a``/``gate_x`` (stored split, or narrowed from whole
    leaves whose gradients then sum over the model axis), or, where a block
    spans ranks, on its columns of its block after one gather of u's
    channels (whose backward sums the ranks' gradients, a reduce-scatter).
    Where ``data`` (the block on FSDP blocks, :func:`fsdp_split`), each rank
    contracts over its part of each block's input channels over the data
    axes, as the reference's GSPMD does there, and both products' partial
    sums are all-reduced over them at once."""
    ga, gx = p["gate_a"], p["gate_x"]
    part = tp.data_group(dist)[1:] if data else (0, 1)
    if not split or ga.shape[0] != n_blocks:
        za, zx = (_block_linear(g, uf, part) for g in (ga, gx))
    else:
        _, r, n = tp.dist_group(dist)
        if n_blocks % n == 0:
            za, zx = (_block_linear(tp.model_block(g, 0, dist), uf, part) for g in (ga, gx))
        else:
            whole = tp.gather_to_model(uf, dist)
            za, zx = (block_columns(tp.copy_to_model(g, dist), whole, r, n, n_blocks, part)
                      for g in (ga, gx))
    if data:
        za, zx = tp.reduce_from_data([za, zx], dist)
    return za, zx


def _gates(p: dict, u: torch.Tensor, split: bool = False, dist=None, data: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, gated input), both f32, for u (..., W), or where ``split`` this
    rank's channels (..., W/n) with its blocks of Lambda; ``data`` as
    :func:`_gate_products`'."""
    uf = u.float()
    za, zx = _gate_products(p, uf, split, dist, data=data)
    r = torch.sigmoid(za)
    i = torch.sigmoid(zx)
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


def rglru_step(p: dict, u: torch.Tensor, h: torch.Tensor, split: bool = False, dist=None,
               data: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step.  u: (B, W); h: (B, W) f32 carried state (the rank's
    channels of both where ``split``); ``data`` as :func:`_gate_products`'."""
    a, gin = _gates(p, u, split, dist, data)
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

# the leaves a split block holds as this rank's blocks over the model axis
# (``specs.SPLIT_COMPUTE``): the dim of W each.  ``gate_a``/``gate_x`` are
# its blocks where n divides their N_BLOCKS, else whole
_SPLIT_DIMS = {"w_gate": -1, "w_in": -1, "conv_w": -1, "conv_b": -1, "lam": -1, "w_out": 0}


def tp_split(cfg: ModelConfig, p: dict, dist=None) -> bool:
    """Whether the block's leaves (one layer's, unstacked) are this rank's
    blocks over the model axis: its channels of ``w_gate``/``w_in``/
    ``conv_w``/``conv_b``/``lam`` and rows of ``w_out`` (all of them or
    none), beside its blocks of the gates or the whole gates.  Anything
    else raises."""
    W = lru_width(cfg)
    got = {k: tp.is_block(f"rec/{k}", p[k].shape[dim], W, dist)
           for k, dim in _SPLIT_DIMS.items()}
    if len(set(got.values())) > 1:
        raise ValueError(f"rec: blocks {sorted(k for k, v in got.items() if v)} beside whole "
                         f"{sorted(k for k, v in got.items() if not v)}")
    split = got["w_in"]
    for k in ("gate_a", "gate_x"):
        if tp.is_block(f"rec/{k} blocks", p[k].shape[0], N_BLOCKS, dist) and not split:
            raise ValueError(f"rec: {k}'s blocks beside whole channels")
    return split


# the leaves a block holds as this rank's FSDP blocks over the data axes
# (``specs.DATA_SPLIT_COMPUTE``): the dim of d each
_FSDP_DIMS = {"w_gate": 0, "w_in": 0, "w_out": -1}


def fsdp_split(cfg: ModelConfig, p: dict, dist=None) -> bool:
    """Whether the block's ``w_gate``/``w_in`` rows and ``w_out`` columns are
    this rank's FSDP blocks over the data axes of ``dist.data_split`` (all
    three or none; anything else raises)."""
    got = {k: tp.is_data_block(f"rec/{k} channels", p[k].shape[dim], cfg.d_model, dist)
           for k, dim in _FSDP_DIMS.items()}
    if len(set(got.values())) > 1:
        raise ValueError(f"rec: FSDP blocks {sorted(k for k, v in got.items() if v)} beside "
                         f"whole {sorted(k for k, v in got.items() if not v)}")
    return got["w_in"]


def _block_in(cfg: ModelConfig, p: dict, x: torch.Tensor, dist):
    """(whether split, whether on FSDP blocks, GeLU(x W_gate), x W_in) on all
    channels or this rank's; ``x`` then sums its gradient over the model
    axis.  On FSDP blocks, x's rank's block of channels through the rows of
    both, their partial sums all-reduced over the data axes at once."""
    split, data = tp_split(cfg, p, dist), fsdp_split(cfg, p, dist)
    if split:
        x = tp.copy_to_model(x, dist)
    if data:
        xb = tp.data_block(x, dist)
        gate, u = tp.reduce_from_data([xb @ p["w_gate"], xb @ p["w_in"]], dist)
    else:
        gate, u = x @ p["w_gate"], x @ p["w_in"]
    return split, data, F.gelu(gate, approximate="tanh"), u


def _block_out(p: dict, gate: torch.Tensor, h: torch.Tensor, split: bool, dist,
               data: bool = False) -> torch.Tensor:
    """(gate * h) W_out; row-parallel where ``split`` (the partial outputs
    summed); on FSDP blocks (``data``) the rank's block of the output's
    channels, gathered over the data axes."""
    out = (gate * h) @ p["w_out"]
    if split:
        out = tp.reduce_from_model(out, dist)
    return tp.gather_from_data(out, dist) if data else out


def rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor, dist=None) -> torch.Tensor:
    """Full-sequence recurrent block.  x: (B, S, d)."""
    return rglru_block_prefill(cfg, p, x, dist)[0]


def rglru_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, dist=None
                        ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence block that also returns the decode cache: h's last row
    in f32 and the last width-1 inputs of the conv (zeros in front when the
    sequence is shorter), of all channels or, with ``dist`` and this rank's
    blocks (:func:`tp_split`), of its channels."""
    split, data, gate, u_raw = _block_in(cfg, p, x, dist)
    u = causal_conv(p, u_raw)
    a, gin = _gates(p, u, split, dist, data)
    hh = _scan_dispatch(a, gin)
    out = _block_out(p, gate, hh.to(u.dtype), split, dist, data)
    width = cfg.conv_width
    conv_tail = u_raw[:, -(width - 1):]
    S = u_raw.shape[1]
    if S < width - 1:  # pad front with zeros (cold conv state)
        conv_tail = F.pad(conv_tail, (0, 0, width - 1 - S, 0))
    return out, {"h": hh[:, -1].float(), "conv": conv_tail}


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    W = lru_width(cfg)
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=dtype_of(cfg), device=device),
    }


def rglru_block_decode(
    cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict, dist=None
) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d) -> (y, cache).  Unlike the JAX package, which returns a
    new cache, this writes the new h and conv state into ``cache`` in place
    and returns the same dict.  With ``dist`` and this rank's blocks
    (:func:`tp_split`) the cache's h (B, W/n) and conv (B, width-1, W/n) are
    its channels."""
    split, data, gate, u_raw = _block_in(cfg, p, x[:, 0], dist)
    u, conv_state = causal_conv_step(p, u_raw, cache["conv"])
    h_out, h_state = rglru_step(p, u, cache["h"], split, dist, data)
    y = _block_out(p, gate, h_out, split, dist, data)[:, None]
    cache["h"].copy_(h_state)
    cache["conv"].copy_(conv_state)
    return y, cache
