"""Int8 gradient compression with error feedback, for the slow tier; ported
from ``repro.optim.compress``.

The paper's lesson is to reshape slow-tier traffic; quantization is the
orthogonal distributed-optimization trick that shrinks it 4x (f32 -> int8 +
one f32 scale per block).  Error feedback keeps SGD/Adam convergence: the
quantization residual is added back into the next step's gradient, so the
bias telescopes.

``compressed_allreduce_slow_inner`` composes the paper's hierarchical
strategy with compression: reduce-scatter over the fast axes in full
precision, quantize only the 1/k shard that must cross the slow axis,
all-gather int8 and scales over it, dequantize + sum, all-gather over the
fast axes.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.comms import routes
from repro_torch.launch.mesh import axes_group, axes_size, mesh_axes

BLOCK = 1024  # per-block scales bound quantization error by max|g|_block/127


def quantize_int8(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32, any shape) -> (q int8 (n_blocks, block), scales f32 (n_blocks,))."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-30)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    block: int = BLOCK) -> torch.Tensor:
    deq = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return deq[:n].reshape(tuple(shape))


def quantize_with_feedback(
    g: torch.Tensor, err: torch.Tensor, block: int = BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: returns (q, scales, new_err)."""
    g_corr = g.to(torch.float32) + err
    q, s = quantize_int8(g_corr, block)
    deq = dequantize_int8(q, s, g.shape, block)
    return q, s, g_corr - deq


# --------------------------------------------------------------------------
# Building block a rank's own program calls.
# --------------------------------------------------------------------------

def _gather_stack(x: torch.Tensor, group, k: int) -> torch.Tensor:
    """All-gather into a new leading dim of size k."""
    out = x.new_empty((k,) + tuple(x.shape))
    routes.all_gather(out.view((k * x.shape[0],) + tuple(x.shape[1:])), x.contiguous(), group)
    return out


def compressed_allreduce_slow_inner(
    x: torch.Tensor,  # this rank's contribution, any shape
    mesh: DeviceMesh,
    slow_axis: str,
    fast_axes: Sequence[str],
    block: int = BLOCK,
) -> torch.Tensor:
    """Hierarchical all-reduce where only int8 (+ scales) crosses ``slow_axis``.

    RS(fast, f32) -> quantize shard -> all_gather(slow, int8) -> local sum
    of dequantized contributions -> AG(fast).
    """
    sizes = mesh_axes(mesh)
    orig_shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % max(axes_size(mesh, fast_axes), 1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat
    for a in fast_axes:
        out = shard.new_empty(shard.numel() // sizes[a])
        routes.reduce_scatter(out, shard.contiguous(), axes_group(mesh, a))
        shard = out
    q, s = quantize_int8(shard, block)
    pods = sizes[slow_axis]
    q_all = _gather_stack(q, axes_group(mesh, slow_axis), pods)  # (pods, nblk, block) int8
    s_all = _gather_stack(s, axes_group(mesh, slow_axis), pods)  # (pods, nblk)
    deq = (q_all.to(torch.float32) * s_all[..., None]).sum(dim=0)
    out = deq.reshape(-1)[: shard.numel()]
    for a in reversed(tuple(fast_axes)):
        full = out.new_empty(out.numel() * sizes[a])
        routes.all_gather(full, out.contiguous(), axes_group(mesh, a))
        out = full
    out = out[: flat.numel() - pad] if pad else out
    return out.reshape(orig_shape)


def compressed_allreduce(
    x: torch.Tensor,
    mesh: DeviceMesh,
    slow_axis: str = "pod",
    fast_axes: Sequence[str] = ("data",),
    block: int = BLOCK,
) -> torch.Tensor:
    """Each rank's contribution over (slow, *fast) -> its slot of the
    approximate sum (the contract of ``comms.allreduce``)."""
    return compressed_allreduce_slow_inner(x, mesh, slow_axis, tuple(fast_axes), block)
