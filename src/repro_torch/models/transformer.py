"""The model: layer groups applied over parameters stacked per group.

Ported from ``repro.models.transformer`` for ATTN, LOCAL, XATTN (gated
cross-attention, llama-vision), ATTNX (self + cross, whisper's decoder),
RWKV and RGLRU layers, with or without post-norms (gemma2), whisper's
encoder, and the MoE layer in place of the MLP of ATTN and LOCAL layers
(mixtral, dbrx).  The parameter tree keeps the JAX package's keys and its
stacking over a group's ``count`` (``_superblock_params``), so a JAX tree
carried across by ``convert.params_from_jax`` runs here unchanged; the
layer loop replaces ``lax.scan`` over the stack.

Distribution: ``DistContext`` carries the mesh (a ``DeviceMesh`` from
``repro_torch.launch.mesh``) and its axis names.  Each rank is a process
that runs ``forward`` on its slot of the batch (its share over the data
axes where they divide the batch, else the whole batch; ``_dp_spec``) and
returns its slot of the reference's output.  Where the parameters are the
rank's blocks over the model axis (``specs.ComputeSharding``) the dense
compute splits over it as the reference's GSPMD splits it
(``sharding.tp``): self- and cross-attention on the rank's heads and the
MLP on its FF block, each ending in one all-reduce, RWKV's time-mix on its
heads and its channel-mix on its FF block (``models.rwkv``), the RG-LRU
block on its channels (``models.griffin``), the embedding and unembedding
on its vocabulary block (the logits are then that block).  Whole
parameters compute whole on every rank; each layer tells the two apart by
its weights' shapes and raises on any other.  Where a decode step's batch
does not split over the data axes, ``DistContext.data_split`` names them
and the layers also compute on the weights' FSDP blocks and the KV caches'
sequence chunks over them (``sharding.tp``'s data-axis operators).  The
MoE layer runs ``moe.moe_apply_sharded_inner`` over
the expert axes with the rank's virtual expert (``_moe_call``); with
``dist=None`` it is the dense single-device path, the reference's branch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import (
    ATTN,
    ATTNX,
    LOCAL,
    RGLRU,
    RWKV,
    XATTN,
    LayerGroup,
    ModelConfig,
)
from repro_torch.models import attention as attn
from repro_torch.models import griffin, moe, rwkv
from repro_torch.models.common import (
    apply_norm,
    dtype_of,
    embed_params,
    gemma_forms,
    META_GEN,
    mlp_apply,
    mlp_params,
    real_generator,
    unembed,
)
from repro_torch.sharding import tp
from repro_torch.sharding.specs import PartitionSpec, Sharding, mesh_shape


PORTED_KINDS = (ATTN, LOCAL, XATTN, ATTNX, RWKV, RGLRU)
AUX_LOSS_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Static distribution context threaded through the model."""

    mesh: Any  # repro_torch.launch.mesh's DeviceMesh
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    ep_shards: int = 1
    moe_strategy: str = "direct"  # direct | chunked | hierarchical
    a2a_chunks: int = 1
    # mesh axes carrying virtual experts; ("data", "model") is the serving
    # layout whose dispatch is the paper's two-hop Alltoall case study
    ep_axes: Tuple[str, ...] = ("model",)
    # the axes over which a step computes on the weights' FSDP blocks and the
    # KV caches' sequence chunks (``sharding.tp``'s data-axis operators): set
    # by the serving steps' decode where the batch does not split over the
    # data axes (``launch.dryrun.serving_steps``), empty everywhere else
    data_split: Tuple[str, ...] = ()

    @property
    def ep_size(self) -> int:
        sizes = mesh_shape(self.mesh)
        return math.prod(sizes[a] for a in self.ep_axes)

    @property
    def dp_size(self) -> int:
        sizes = mesh_shape(self.mesh)
        return math.prod(sizes[a] for a in self.dp_axes)


def _dp_spec(dist: Optional[DistContext], batch: int, ndim: int = 3) -> PartitionSpec:
    """Batch-sharded spec when the batch divides the DP extent, else
    replicated (long-context decode with batch 1)."""
    if dist is None or dist.dp_size == 1 or batch % dist.dp_size:
        return PartitionSpec(*([None] * ndim))
    return PartitionSpec(dist.dp_axes, *([None] * (ndim - 1)))


def batch_slot(dist: Optional[DistContext], x: torch.Tensor) -> torch.Tensor:
    """This rank's slot of the global batch ``x`` (leading dim the batch)."""
    if dist is None:
        return x
    return Sharding(dist.mesh, _dp_spec(dist, x.shape[0], x.ndim)).shard(x)


def batch_gather(dist: Optional[DistContext], x: torch.Tensor, batch: int) -> torch.Tensor:
    """The global batch (``batch`` rows) from every rank's slot ``x``:
    collective over the mesh."""
    if dist is None:
        return x
    return Sharding(dist.mesh, _dp_spec(dist, batch, x.ndim)).gather(x)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs models whose layers are any mix of the ported kinds,
    with or without post-norms, an encoder and experts (the MoE layer of
    ATTN and LOCAL layers)."""
    kinds = {k for g in cfg.groups for k in g.pattern}
    if not kinds <= set(PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}; the port runs models whose "
            f"layers are each one of {PORTED_KINDS}")


# --------------------------------------------------------------------------
# Parameter init: same keys, shapes, dtypes and std as the JAX package.
# --------------------------------------------------------------------------

def norm_params(cfg: ModelConfig, lead: Tuple[int, ...], device) -> dict:
    if cfg.norm == "nonparam_ln":
        return None
    # the gemma forms' (1 + scale) RMSNorm starts from scale 0
    fill = 0.0 if cfg.norm == "rmsnorm" and gemma_forms(cfg) else 1.0
    p = {"scale": torch.full(lead + (cfg.d_model,), fill, dtype=dtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype_of(cfg), device=device)
    return p


def _layer_params(cfg: ModelConfig, kind: str, gen: torch.Generator,
                  lead: Tuple[int, ...], ep_shards: int = 1,
                  expert_block: Optional[Tuple[int, int]] = None) -> dict:
    p = {"ln1": norm_params(cfg, lead, gen.device), "ln2": norm_params(cfg, lead, gen.device)}
    if kind in (ATTN, LOCAL):
        p["attn"] = attn.attn_params(cfg, gen, lead)
        if cfg.is_moe:
            p["moe"] = moe.moe_params(cfg, gen, lead, ep_shards, expert_block)
        else:
            p["mlp"] = mlp_params(cfg, gen, lead)
        if cfg.post_norms:
            p["post_ln1"] = norm_params(cfg, lead, gen.device)
            p["post_ln2"] = norm_params(cfg, lead, gen.device)
    elif kind == XATTN:  # gated cross-attention layer (llama-vision)
        p["xattn"] = attn.attn_params(cfg, gen, lead, kv_input_dim=cfg.frontend_dim or cfg.d_model)
        p["mlp"] = mlp_params(cfg, gen, lead)
        # tanh(0) = 0: a fresh layer adds nothing until its gates are trained
        p["gate_attn"] = torch.zeros(lead, dtype=torch.float32, device=gen.device)
        p["gate_mlp"] = torch.zeros(lead, dtype=torch.float32, device=gen.device)
    elif kind == ATTNX:  # whisper decoder layer: self + cross + mlp
        p["attn"] = attn.attn_params(cfg, gen, lead)
        p["ln_x"] = norm_params(cfg, lead, gen.device)
        p["xattn"] = attn.attn_params(cfg, gen, lead, kv_input_dim=cfg.d_model)
        p["mlp"] = mlp_params(cfg, gen, lead)
    elif kind == RWKV:
        p["tm_cm"] = rwkv.rwkv_params(cfg, gen, lead)
    elif kind == RGLRU:
        p["rec"] = griffin.rglru_params(cfg, gen, lead)
        p["mlp"] = mlp_params(cfg, gen, lead)
    else:
        raise ValueError(kind)
    return p


def _superblock_params(cfg: ModelConfig, group: LayerGroup, gen: torch.Generator,
                       ep_shards: int = 1,
                       expert_block: Optional[Tuple[int, int]] = None) -> tuple:
    """One dict per layer kind of the pattern, leaves stacked over ``count``."""
    return tuple(_layer_params(cfg, kind, gen, (group.count,), ep_shards, expert_block)
                 for kind in group.pattern)


def _encoder_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Whisper's encoder: ``layers`` one dict whose leaves are stacked over
    ``encoder_layers``, its final norm and learned positions (std 0.02)."""
    lead = (cfg.encoder_layers,)
    pos = 0.02 * torch.randn((max(cfg.frontend_tokens, 1), cfg.d_model),
                             generator=real_generator(gen),
                             dtype=torch.float32, device=gen.device)
    return {
        "layers": {
            "ln1": norm_params(cfg, lead, gen.device),
            "attn": attn.attn_params(cfg, gen, lead),
            "ln2": norm_params(cfg, lead, gen.device),
            "mlp": mlp_params(cfg, gen, lead),
        },
        "final_norm": norm_params(cfg, (), gen.device),
        "pos": pos.to(dtype_of(cfg)),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, ep_shards: int = 1,
                expert_block: Optional[Tuple[int, int]] = None) -> dict:
    """Random weights on ``gen``'s device, the MoE experts in the virtual
    layout of ``ep_shards``.  ``expert_block`` (start, n) keeps only those
    virtual experts of each MoE layer (a rank's block over the expert
    axes); every other leaf, and every value kept, is what the whole draw
    gives."""
    check_supported(cfg)
    params = {
        "embed": embed_params(cfg, gen),
        "groups": tuple(_superblock_params(cfg, g, gen, ep_shards, expert_block)
                        for g in cfg.groups),
        "final_norm": norm_params(cfg, (), gen.device),
    }
    if cfg.encoder_layers:
        params["encoder"] = _encoder_params(cfg, gen)
    return params


def param_shapes(cfg: ModelConfig, ep_shards: int = 1) -> dict:
    """``init_params``'s tree on the meta device: shapes and dtypes only."""
    return init_params(cfg, META_GEN, ep_shards)


def _take(tree, i: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(gp: tuple, i: int) -> tuple:
    """Repetition ``i`` of a group's stacked parameters (or caches), as views:
    one dict per layer kind of the pattern."""
    return tuple(_take(p, i) for p in gp)


def _unstack(tree, count: int) -> list:
    if tree is None:
        return [None] * count
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(count)]
    return list(torch.unbind(tree, 0))


def unstack_params(gp: tuple, count: int) -> list:
    """Every repetition's ``layer_params`` at once, each stacked leaf split by
    one ``torch.unbind``: its backward writes the stacked gradient once,
    where ``count`` separate selects would each write a zero-filled
    gradient of the whole stack (the counterpart of the JAX package's scan,
    which writes each repetition's gradient into its slice)."""
    per_kind = [_unstack(p, count) for p in gp]
    return [tuple(kind[i] for kind in per_kind) for i in range(count)]


# --------------------------------------------------------------------------
# Forward (full sequence).
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype`` first, as the JAX package casts it,
    as a host number: multiplying by it rounds as multiplying by a 0-d tensor
    of ``dtype`` does, and no step copies it to the device."""
    return float(torch.tensor(d_model**0.5, dtype=dtype))


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  dist: Optional[DistContext] = None) -> torch.Tensor:
    x = tp.vocab_embed(params["embed"]["tok"], tokens, cfg.vocab_padded, dist)
    if tp.is_data_block("embed/tok columns", x.shape[-1], cfg.d_model, dist):
        x = tp.gather_from_data(x, dist)  # the table is the rank's FSDP block
    if gemma_forms(cfg):
        x = x * _embed_scale(cfg.d_model, x.dtype)
    return x


def _positions_embed(cfg: ModelConfig, params: dict, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Learned positions gathered on the device (``positions`` is a tensor,
    in decode the 0-d step position as a (1,) view), so a captured step reads
    nothing on the host."""
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"].index_select(0, positions)
    return x


def gate(p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """tanh of an XATTN layer's 0-d f32 gate, in ``x``'s dtype, on the device."""
    return torch.tanh(p[key]).to(x.dtype)


def post_norm(cfg: ModelConfig, p: dict, key: str, y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output through its post-norm (``post_ln1`` after
    attention, ``post_ln2`` after the MLP) where the config has them."""
    return apply_norm(cfg, y, p[key]) if cfg.post_norms else y


def _moe_call(cfg: ModelConfig, p: dict, x: torch.Tensor, dist: Optional[DistContext],
              with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE layer: dense on one device; over the expert axes with this
    rank's virtual expert in a world.  ``p``'s expert leaves are the
    rank's block (one virtual expert) or whole (E·r; the rank's row is
    taken).  Where an expert axis is also a data axis (the serving layout),
    x enters whole: the slots are gathered over the data axes first and the
    rank's slot is taken back after; that layout is forward-only.
    ``with_aux=False`` skips the aux loss's means across ranks (None)."""
    if dist is None:
        return moe.moe_apply_dense(cfg, p, x)
    from repro_torch.launch.mesh import axes_group, axes_index

    sizes = mesh_shape(dist.mesh)
    ax = moe.MoEAxis(dist.ep_axes, dist.ep_size, dist.ep_shards,
                     axis_sizes=tuple(sizes[a] for a in dist.ep_axes))
    moe.check_ep_layout(cfg, ax.size, ax.ep_shards)
    m = axes_index(dist.mesh, ax.names)
    w = {"router": p["router"]}
    for key in ("w_in", "w_out"):
        leaf = p[key]
        if leaf.shape[0] == ax.size:  # whole: take this rank's virtual expert
            leaf = leaf.narrow(0, m, 1)
        elif leaf.shape[0] != 1:
            raise ValueError(f"moe/{key} {tuple(leaf.shape)}: neither whole ({ax.size} "
                             "virtual experts) nor this rank's one")
        w[key] = leaf
    dp = dist.dp_size
    dp_clash = dp > 1 and any(a in dist.ep_axes for a in dist.dp_axes)
    xl = x
    if dp_clash:
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "gradients through the expert layer need expert axes apart from the data "
                f"axes; ep_axes {dist.ep_axes} share {dist.dp_axes}")
        xl = batch_gather(dist, x, x.shape[0] * dp)
    y, aux = moe.moe_apply_sharded_inner(cfg, w, xl, ax, dist.mesh,
                                         strategy=dist.moe_strategy,
                                         a2a_chunks=dist.a2a_chunks, with_aux=with_aux)
    if dp_clash:
        y = batch_slot(dist, y)
    if dp > 1 and with_aux:
        # aux is already averaged over the expert axes; average the data
        # axes too so it is the same on every rank (the losses it joins are
        # averaged over the data axes afterwards: backward passes it on)
        aux = moe.mean_over(aux, axes_group(dist.mesh, dist.dp_axes), 1.0)
    return y, aux


def feed_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 dist: Optional[DistContext] = None, with_aux: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An ATTN or LOCAL layer's MLP, or its MoE layer where the config has
    experts: (output, the router's aux loss, or None for the MLP).  Serving
    drops the aux loss (``with_aux=False``: a world then skips its means)."""
    if cfg.is_moe:
        return _moe_call(cfg, p["moe"], h, dist, with_aux)
    return mlp_apply(cfg, p["mlp"], h, dist), None


def _apply_layer_full(
    cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, positions: torch.Tensor,
    enc: Optional[torch.Tensor] = None,  # what XATTN / ATTNX layers attend to
    aux: Optional[list] = None,  # collects each MoE layer's aux loss
    dist: Optional[DistContext] = None,
) -> torch.Tensor:
    if kind in (ATTN, LOCAL):
        h = apply_norm(cfg, x, p["ln1"])
        a = attn.self_attention(
            cfg, p["attn"], h, positions, window=cfg.window if kind == LOCAL else 0, dist=dist
        )
        x = x + post_norm(cfg, p, "post_ln1", a)
        h = apply_norm(cfg, x, p["ln2"])
        m, layer_aux = feed_forward(cfg, p, h, dist)
        if aux is not None and layer_aux is not None:
            aux.append(layer_aux)
        return x + post_norm(cfg, p, "post_ln2", m)
    if kind == XATTN:
        h = apply_norm(cfg, x, p["ln1"])
        a = attn.cross_attention(cfg, p["xattn"], h, attn.cross_kv(cfg, p["xattn"], enc, dist),
                                 dist)
        x = x + gate(p, "gate_attn", x) * a
        h = apply_norm(cfg, x, p["ln2"])
        return x + gate(p, "gate_mlp", x) * mlp_apply(cfg, p["mlp"], h, dist)
    if kind == ATTNX:
        h = apply_norm(cfg, x, p["ln1"])
        x = x + attn.self_attention(cfg, p["attn"], h, positions, dist=dist)
        h = apply_norm(cfg, x, p["ln_x"])
        x = x + attn.cross_attention(cfg, p["xattn"], h,
                                     attn.cross_kv(cfg, p["xattn"], enc, dist), dist)
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h, dist)
    if kind == RWKV:
        h = apply_norm(cfg, x, p["ln1"])
        x = x + rwkv.rwkv_time_mix(cfg, p["tm_cm"], h, dist=dist)
        h = apply_norm(cfg, x, p["ln2"])
        return x + rwkv.rwkv_channel_mix(cfg, p["tm_cm"], h, dist)
    if kind == RGLRU:
        h = apply_norm(cfg, x, p["ln1"])
        x = x + griffin.rglru_block(cfg, p["rec"], h, dist)
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h, dist)
    raise ValueError(kind)


def _run_encoder(cfg: ModelConfig, params: dict, frontend: torch.Tensor,
                 dist: Optional[DistContext] = None) -> torch.Tensor:
    """Whisper's encoder: learned positions, then per layer bidirectional
    self-attention (flash with ``causal=False`` when kernels are on) and
    the MLP, each behind its norm; then the final norm."""
    enc_p = params["encoder"]
    T = frontend.shape[1]
    x = frontend + enc_p["pos"][None, :T]
    positions = torch.arange(T, dtype=torch.int32, device=frontend.device)
    for p in _unstack(enc_p["layers"], cfg.encoder_layers):
        h = apply_norm(cfg, x, p["ln1"])
        x = x + attn.self_attention(cfg, p["attn"], h, positions, causal=False, dist=dist)
        h = apply_norm(cfg, x, p["ln2"])
        x = x + mlp_apply(cfg, p["mlp"], h, dist)
    return apply_norm(cfg, x, enc_p["final_norm"])


def frontend_states(cfg: ModelConfig, params: dict, frontend: Optional[torch.Tensor],
                    dist: Optional[DistContext] = None) -> Optional[torch.Tensor]:
    """What the cross-attention layers attend to: the encoder's output where
    the model has an encoder (whisper), the raw patch embeddings for a
    vision-language model, else None."""
    if cfg.encoder_layers:
        return _run_encoder(cfg, params, frontend, dist)
    if cfg.family == "vlm":
        return frontend
    return None


def _block(cfg: ModelConfig, pattern: Tuple[str, ...], dist: Optional[DistContext],
           x: torch.Tensor, aux: torch.Tensor, p_block: tuple, positions: torch.Tensor,
           enc: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repetition of a group's pattern, the unit remat recomputes:
    (x, aux plus the MoE layers' aux losses in layer order).  The aux
    losses are collected here and returned, so a re-run in backward adds
    nothing twice."""
    auxes = []
    for kind, p in zip(pattern, p_block):
        x = _apply_layer_full(cfg, kind, p, x, positions, enc, auxes, dist)
    for a in auxes:  # summed in layer order, as the reference's scan carries it
        aux = aux + a
    return x, aux


def _save_mm_outputs():
    """Selective checkpointing's contexts for ``remat="dots"``: keep the
    outputs of ``aten.mm`` (the projections, products with no batch
    dimensions) and recompute the rest, ``bmm`` included: the counterpart
    of JAX's ``dots_with_no_batch_dims_saveable``."""
    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default])


def _remat_block(remat, block):
    """``block`` under the remat policy of the JAX package's ``forward``:
    ``True`` / ``"block"`` recomputes the whole repetition in backward,
    ``"dots"`` keeps the projections' outputs, anything else keeps
    everything."""
    if remat in (True, "block"):
        return functools.partial(checkpoint, block, use_reentrant=False)
    if remat == "dots":
        return functools.partial(checkpoint, block, use_reentrant=False,
                                 context_fn=_save_mm_outputs)
    return block


def forward(
    cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
    frontend: Optional[torch.Tensor] = None,  # (B, T, frontend_dim) stub embeddings
    dist: Optional[DistContext] = None,
    remat=False,  # False / "none" | True / "block" | "dots"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) f32, aux_loss scalar): the MoE routers' aux
    losses summed over the layers, times ``AUX_LOSS_COEF``; zero without
    experts.  ``remat`` checkpoints each repetition of a group's pattern
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package's
    ``jax.checkpoint`` around its scan body; its recompute repeats the
    forward's all-reduces over the model axis, as GSPMD's remat repeats its
    collectives.  With ``dist``, ``tokens`` (and ``frontend``) are this
    rank's slot and so are the logits: of its vocabulary block where the
    embedding is its block over the model axis."""
    check_supported(cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    enc = frontend_states(cfg, params, frontend, dist)
    x = _embed_tokens(cfg, params, tokens, dist)
    x = _positions_embed(cfg, params, x, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for group, gp in zip(cfg.groups, params["groups"]):
        body = _remat_block(remat, functools.partial(_block, cfg, group.pattern, dist))
        for p_block in unstack_params(gp, group.count):
            x, aux_total = body(x, aux_total, p_block, positions, enc)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed(cfg, params["embed"], x, dist), aux_total * AUX_LOSS_COEF
