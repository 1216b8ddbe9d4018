"""Step functions, ported from ``repro.models.steps``.

``train_step`` — forward + loss + backward + AdamW update (+ optional
microbatch gradient accumulation).  ``prefill_step`` and ``decode_step``
are serving's steps, thin calls into ``models.decode.prefill`` and
``decode_step`` as in the reference.

The reference trains on its plain path (its Pallas kernels have no VJP), so
training here runs plain PyTorch with the kernels off; the kernel wrappers
refuse inputs that require grad.  ``train_step`` takes gradients with
``torch.autograd.grad`` over detached leaves that share the parameters'
storage, then updates the parameters and the optimizer's state in place
(``optim.adamw.apply_updates``) and returns the same trees.  Its two
parts are ``train.grads`` (forward and backward, every microbatch) and
``train.update`` (clip, schedule, AdamW) spans, which are also profiler
ranges.

With ``dist`` it is the sharded step.  Each rank holds its block of every
parameter and AdamW moment (by ``sharding.param_shardings``) and its slot
of the batch.  The step gathers each leaf for compute (``train.gather``,
``specs.compute_shardings``): a leaf whose products split over the model
axis (self- and cross-attention's, the dense MLP's, RWKV's time-mix and
channel-mix's, the vocabulary's) over its FSDP axes only, keeping its
model block (a gated ``w_in``'s storage block is exchanged into its
compute block), any other leaf whole.  Forward and backward then split
over the model axis as the reference's GSPMD splits them
(``sharding.tp``: the rank's heads, FF block and vocabulary block, one
all-reduce per attention block and per MLP, RWKV's decay and output
all-reduces and its channel-mix's reduce-scatter and all-gather, the
vocabulary-parallel cross-entropy), so each rank's gradient of a split
leaf is its model block of the whole gradient and of any other leaf the
whole gradient (summed over the model axis where the rank used a block
of it: ``tp.model_block``).  The step
sums the gradients over the data axes and divides (``train.reduce``),
keeps the rank's storage block (exchanging a gated ``w_in``'s back) and
applies AdamW to the blocks, so that each rank ends with its block of what
the single-device step computes.  The global gradient norm counts each
element once: a block held by several ranks adds its squares divided by
their number.

With ``opt_shardings`` apart from ``shardings`` the moments lie on their
own FSDP axes: ZeRO-1 (the reference's ``--opt-fsdp-axes pod+data``, each
moment split over the pods too) or the reference's ``--no-fsdp`` (whole
parameters, moments split over "data").  The step then cuts each reduced
gradient to the rank's moment block (``specs.moment_compute_shardings``),
counts the norm by the moments' replicas, and applies AdamW to the
parameter's values at that block, cut from the compute tensor it gathered
(``moment_values``): a moment block need not lie inside the rank's
parameter block, and where a dim divides the parameters' axes but not the
moments', the moments are the less split.  ``train.param_gather`` then
all-gathers the updated values over the moments' FSDP axes and writes the
rank's parameter block in place (``gather_back``).  Where every moment
lies in its parameter's layout the step is the one above, bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import decode as dec
from repro_torch.models.common import dtype_of
from repro_torch.models.convert import tree_leaves, tree_unflatten
from repro_torch.models.transformer import DistContext, forward, param_shapes
from repro_torch.obs import trace
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding import tp


def next_token_loss(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S)
    *,
    frontend: Optional[torch.Tensor] = None,
    dist: Optional[DistContext] = None,
    remat=False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy (+ MoE aux loss); over the vocabulary
    blocks of the model axis where the logits are the rank's block
    (``tp.vocab_nll``)."""
    logits, aux = forward(cfg, params, tokens, frontend=frontend, dist=dist, remat=remat)
    nll = tp.vocab_nll(logits[:, :-1], tokens[:, 1:].long(), cfg.vocab_padded, dist)
    ce = nll.mean()
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def check_frontend(cfg: ModelConfig, frontend: Optional[torch.Tensor]) -> None:
    """Refuse a frontend in another dtype than the model's, as the reference
    fails on one: its ``forward``'s ``lax.scan`` stops because an f32
    frontend promotes the bf16 carry to f32 (``repro.launch.train --arch
    whisper-small`` or ``llama-3.2-vision-11b`` in bf16)."""
    if frontend is not None and frontend.dtype != dtype_of(cfg):
        raise ValueError(
            f"{cfg.name}: frontend is {frontend.dtype}, the model is {dtype_of(cfg)}; the "
            "reference's train step fails on this input (an f32 frontend promotes its "
            "lax.scan carry from bf16 to f32), so the port refuses it: cast the frontend "
            "to the model's dtype")


def _loss_and_grads(cfg, params, leaves, tokens, frontend, remat, dist):
    """(loss, metrics, one gradient for each of ``leaves`` in their dtypes)."""
    loss, metrics = next_token_loss(cfg, params, tokens, frontend=frontend, dist=dist,
                                    remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def train_step(
    cfg: ModelConfig,
    run: RunConfig,
    params: dict,
    opt_state: adamw.AdamWState,
    batch: Dict[str, torch.Tensor],  # {"tokens": (B,S)[, "frontend": ...]}
    *,
    dist: Optional[DistContext] = None,
    shardings=None,
    opt_shardings=None,
) -> Tuple[dict, adamw.AdamWState, Dict[str, torch.Tensor]]:
    """One optimizer step.  ``run.n_microbatches > 1`` accumulates gradients
    over microbatches in ``run.grad_accum_dtype`` (activation memory
    O(microbatch)), used only where it divides the batch, as in the
    reference; the metrics then hold only the mean loss.

    With ``dist``: ``params`` and ``opt_state``'s moments are this rank's
    blocks by ``shardings`` (default: ``param_shardings`` of the config's
    shapes over ``dist.mesh``), ``batch`` is its slot; the metrics are
    global (averaged over the data axes).  ``opt_shardings`` (an
    ``AdamWState`` of shardings, or the moments' tree; default: the
    parameters') lays the moments out on their own FSDP axes (ZeRO-1)."""
    tokens = batch["tokens"]
    frontend = batch.get("frontend")
    check_frontend(cfg, frontend)
    remat_mode = run.remat_policy if run.remat else "none"
    plan = o_plan = at_moments = None
    if dist is None:
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    else:
        from repro_torch.sharding.specs import compute_shardings, param_shardings

        if shardings is None:
            shardings = param_shardings(param_shapes(cfg, dist.ep_shards), dist.mesh)
        plan = tree_leaves(compute_shardings(shardings, gated=cfg.gated,
                                             model_axis=dist.model_axis))
        o_plan = _moment_plan(cfg, dist, shardings, opt_shardings, plan)
        _sync_if_traced(tokens)
        with trace.span("train.gather"):
            leaves = [c.to_compute(p.detach()).requires_grad_()
                      for c, p in zip(plan, tree_leaves(params))]
            if o_plan is not plan:
                at_moments = moment_values(o_plan, plan, leaves, tree_leaves(params))
    diff_params = tree_unflatten(params, leaves)

    with trace.span("train.grads", microbatches=run.n_microbatches):
        metrics, grads = _grads(cfg, run, diff_params, leaves, tokens, frontend, remat_mode,
                                dist)
    del diff_params, leaves
    gnorm = None
    if dist is not None:
        _sync_if_traced(tokens)
        with trace.span("train.reduce"):
            metrics, grads, gnorm = _reduce(dist, o_plan, metrics, grads)
    with trace.span("train.update"):
        grads, gnorm = adamw.clip_by_global_norm(grads, run.grad_clip, gnorm)
        lr = warmup_cosine(
            opt_state.step,
            peak_lr=run.learning_rate,
            warmup_steps=run.warmup_steps,
            total_steps=run.total_steps,
        )
        _, opt_state = adamw.apply_updates(
            adamw.AdamWConfig(
                lr=run.learning_rate,
                weight_decay=run.weight_decay,
                grad_clip=run.grad_clip,
            ),
            params if at_moments is None else at_moments,
            grads,
            opt_state,
            lr=lr,
        )
    if at_moments is not None:
        _sync_if_traced(tokens)
        with trace.span("train.param_gather"):
            gather_back(o_plan, plan, at_moments, tree_leaves(params))
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return params, opt_state, metrics


def prefill_step(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    *,
    frontend: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
    dist: Optional[DistContext] = None,
):
    return dec.prefill(cfg, params, tokens, frontend=frontend, capacity=capacity, dist=dist)


def decode_step(
    cfg: ModelConfig,
    params: dict,
    caches: tuple,
    token: torch.Tensor,
    pos,
    *,
    dist: Optional[DistContext] = None,
):
    return dec.decode_step(cfg, params, caches, token, pos, dist=dist)


def _sync_if_traced(t: torch.Tensor) -> None:
    """With a tracer on, a sharded step's ``train.gather`` and
    ``train.reduce`` spans start on an idle card, so each holds its
    collectives and not the device work enqueued before it."""
    if trace.is_active() and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _moment_plan(cfg, dist, shardings, opt_shardings, plan: list) -> list:
    """The moments' ``ComputeSharding`` of each leaf (``specs.
    moment_compute_shardings``), or ``plan`` itself where every moment lies
    in its parameter's layout."""
    if opt_shardings is None:
        return plan
    from repro_torch.sharding.specs import moment_compute_shardings

    o_plan = tree_leaves(moment_compute_shardings(opt_shardings, shardings, gated=cfg.gated,
                                                  model_axis=dist.model_axis))
    if all(o.storage.spec == c.storage.spec for o, c in zip(o_plan, plan)):
        return plan
    return o_plan


def moment_values(o_plan: list, plan: list, compute: list, params: list) -> list:
    """The parameters' values at this rank's block of each moment: the
    parameter block itself where the moments lie in its layout, else a new
    tensor cut from the compute tensor (which holds values of the leaf
    beyond the rank's parameter block).  Collective where a gated ``w_in``
    is exchanged."""
    with torch.no_grad():
        return [o.to_storage(t.detach()) if o.storage.spec != c.storage.spec else p
                for o, c, t, p in zip(o_plan, plan, compute, params)]


def gather_back(o_plan: list, plan: list, at_moments: list, params: list) -> None:
    """Write the values at the moment blocks (``moment_values``, updated by
    ``apply_updates``) into this rank's parameter blocks in place where
    the two differ: an all-gather over the moments' FSDP axes, then the
    parameter's block of it (a gated ``w_in``'s storage columns are the
    same in both layouts, so neither is exchanged).  Collective."""
    with torch.no_grad():
        for o, c, v, p in zip(o_plan, plan, at_moments, params):
            if o.storage.spec != c.storage.spec:
                p.copy_(c.gather.block(o.gather.gather(v)))


def _reduce(dist: DistContext, plan: list, metrics: dict, grads: list):
    """The sharded step's reductions: (metrics averaged over the data axes,
    this rank's storage block of each gradient summed over the data axes and
    divided, the global norm of the whole gradient).  A split leaf's
    gradient is already its model block: only that block is reduced."""
    import torch.distributed as tdist

    from repro_torch.comms import routes
    from repro_torch.launch.mesh import axes_group

    dp = dist.dp_size
    if dp > 1:
        group = axes_group(dist.mesh, dist.dp_axes)
        for g in grads:
            routes.all_reduce(g, group)
            g.div_(dp)
        vals = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
        routes.all_reduce(vals, group)
        metrics = dict(zip(metrics, (vals / dp).unbind()))
    blocks = [c.to_storage(g) for c, g in zip(plan, grads)]
    # each element once: a block held by n ranks adds its squares over n
    sq = torch.zeros((1,), dtype=torch.float32, device=blocks[0].device)
    for c, b in zip(plan, blocks):
        sq += torch.sum(torch.square(b.to(torch.float32))) / c.storage.replicas
    routes.all_reduce(sq, tdist.group.WORLD)
    return metrics, blocks, torch.sqrt(sq[0])


def _grads(cfg, run, params, leaves, tokens, frontend, remat, dist=None):
    """(metrics, one gradient for each of ``leaves``): over the whole batch,
    or summed over microbatches in ``run.grad_accum_dtype`` and divided in
    f32 where ``run.n_microbatches`` divides the batch (the metrics then
    hold only the mean loss), as the reference does."""
    n_micro = max(run.n_microbatches, 1)
    B = tokens.shape[0]
    if n_micro > 1 and B % n_micro == 0:
        acc_dt = torch.bfloat16 if run.grad_accum_dtype == "bfloat16" else torch.float32
        acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
        tot_l = 0.0
        for i in range(n_micro):
            sl = slice(i * (B // n_micro), (i + 1) * (B // n_micro))
            l, _, g = _loss_and_grads(cfg, params, leaves, tokens[sl],
                                      None if frontend is None else frontend[sl], remat, dist)
            tot_l = tot_l + l
            for a, gi in zip(acc, g):
                a.add_(gi.to(acc_dt))
            del g
        # f32 accumulators are divided in place (``to`` returns them as they are)
        return {"loss": tot_l / n_micro}, [a.to(torch.float32).div_(n_micro) for a in acc]
    _, metrics, grads = _loss_and_grads(cfg, params, leaves, tokens, frontend, remat, dist)
    return metrics, grads
