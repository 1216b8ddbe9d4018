"""Sharding rules: parameter / optimizer / cache partition specs.

Ported from ``repro.sharding.specs``.  Logical placement (mesh axes:
optional "pod", "data", "model"):
  * TP   — attention heads, MLP hidden, vocab, experts, recurrent widths
           shard over "model".
  * FSDP — each param's non-TP large dim additionally shards over "data"
           ("pod" stays pure DP so only gradient reduction crosses the slow
           tier — the paper's staging rule).
  * DP   — batch over ("pod", "data").

Every rule degrades gracefully: an axis is only assigned if the dim is
divisible by the mesh axis size (e.g. whisper's 12 heads on a 16-way model
axis simply stay replicated).

``tp_adapt`` rewrites a config for a TP width: GQA KV heads that do not
divide the axis are *expanded* (each KV head duplicated tp/KV times, the
weight shapes say so); MoE expert counts below the axis size get
``ep_shards`` (see models/moe.py).

The rules are the reference's.  What differs is what they return.  A mesh
is anything with axis sizes: a ``DeviceMesh`` from
``repro_torch.launch.mesh``, a ``{axis: size}`` mapping, or an object whose
``shape`` is such a mapping.  A spec is a :class:`PartitionSpec`, a tuple
with one entry a dim: an axis name, a tuple of names (the dim split over
their product, the first name major), or None.  ``param_shardings`` returns
a tree of :class:`Sharding` over the parameter tree, its paths the
reference's ``_path_str`` strings (``groups/0/0/attn/wq``).  In a
``torch.distributed`` world each rank holds its block of a leaf:
``Sharding.shard`` takes it from the whole leaf by the rank's coordinates
on the mesh, and ``Sharding.gather`` puts the whole leaf back together with
all-gathers over the spec's axes (through ``comms.routes``).
``compute_shardings`` says how a step computes with each leaf: the leaves
whose products split over "model" (``SPLIT_COMPUTE``: self- and
cross-attention, the dense MLP, RWKV's time-mix and channel-mix, the
RG-LRU block, the vocabulary; ``sharding.tp``) keep their model block and are gathered over
their other axes only; every other leaf is gathered whole.
``moment_compute_shardings`` does the same for AdamW moments stored on
other FSDP axes than their parameters (ZeRO-1), and refuses moments that
would compute in another layout.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """One entry a dim of the leaf: an axis name, a tuple of axis names, or
    None (not split)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, a mapping, or an object whose
    ``shape`` is a mapping (the reference's tests pass
    ``SimpleNamespace(shape=...)``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement: ``spec`` over ``mesh``."""

    mesh: Any
    spec: PartitionSpec

    def shard(self, full: torch.Tensor,
              coord: Optional[Mapping[str, int]] = None) -> torch.Tensor:
        """This rank's block of the whole leaf ``full``, a new tensor.
        ``coord`` (axis -> index) defaults to this rank's coordinates on a
        ``DeviceMesh``."""
        return self.block(full, coord).clone(memory_format=torch.contiguous_format)

    def block(self, full: torch.Tensor,
              coord: Optional[Mapping[str, int]] = None) -> torch.Tensor:
        """This rank's block of ``full`` as a view (see :meth:`shard`)."""
        sizes = mesh_shape(self.mesh)
        if coord is None:
            coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        out = full
        for dim, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            if not axes:
                continue
            k = math.prod(sizes[a] for a in axes)
            idx = 0
            for a in axes:  # row-major over the entry's axes
                idx = idx * sizes[a] + coord[a]
            n = full.shape[dim] // k
            out = out.narrow(dim, idx * n, n)
        return out

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's ``block``: one all-gather over
        each split dim's axes, in the mesh's order of ranks.  Collective:
        every rank of the mesh calls it."""
        from repro_torch.comms import routes
        from repro_torch.launch.mesh import axes_group

        out = block
        for dim, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            if not axes:
                continue
            group = axes_group(self.mesh, axes)
            k = math.prod(mesh_shape(self.mesh)[a] for a in axes)
            part = out.movedim(dim, 0).contiguous()
            whole = part.new_empty((k * part.shape[0],) + tuple(part.shape[1:]))
            routes.all_gather(whole, part, group)
            out = whole.movedim(0, dim)
        return out.contiguous()

    @property
    def replicas(self) -> int:
        """How many ranks hold each block: the product of the mesh axes the
        spec does not split over."""
        sizes = mesh_shape(self.mesh)
        used = {a for e in self.spec for a in _entry_axes(e)}
        return math.prod(n for a, n in sizes.items() if a not in used)


def gather_to_host(shardings: Any, tree: Any, keep: bool = True) -> Any:
    """The whole tree from this rank's blocks, gathered one leaf at a time
    (collective: every rank of the mesh calls it), each whole leaf moved to
    the host as soon as it is whole where ``keep``, else dropped (its leaf
    None): a full-width tree never sits whole on a card.  The gather runs
    where the blocks lie: on the host, its transposes would run on one
    thread (4x slower at full width on one H100)."""
    from repro_torch.models.convert import tree_map2

    def one(s: Sharding, t: torch.Tensor):
        whole = s.gather(t.detach())
        return whole.cpu() if keep else None

    return tree_map2(one, shardings, tree)


# --------------------------------------------------------------------------
# Config adaptation for a TP width.
# --------------------------------------------------------------------------

def tp_adapt(cfg: ModelConfig, tp: int) -> Tuple[ModelConfig, int]:
    """Returns (deploy config, ep_shards).

    * KV expansion: if heads shard (H % tp == 0) but KV doesn't divide tp,
      and tp % KV == 0, expand n_kv_heads -> tp (duplicated KV heads).
    * MoE: ep_shards = tp // n_experts when experts don't fill the axis.
    """
    new = cfg
    if cfg.n_heads % tp == 0 and cfg.n_kv_heads < cfg.n_heads:
        if cfg.n_kv_heads % tp != 0 and tp % cfg.n_kv_heads == 0:
            new = dataclasses.replace(new, n_kv_heads=tp)
    ep_shards = 1
    if cfg.is_moe:
        if cfg.n_experts % tp == 0:
            ep_shards = 1  # experts tile the axis exactly (or a multiple)
        elif tp % cfg.n_experts == 0:
            ep_shards = tp // cfg.n_experts
    return new, ep_shards


# --------------------------------------------------------------------------
# Path-rule engine.
# --------------------------------------------------------------------------

def map_with_path(fn: Callable[[str, Any], Any], tree, path: Tuple[str, ...] = ()):
    """``fn(path_str, leaf)`` over a port tree (dicts, tuples, lists,
    NamedTuples; None stays None), the path joined by "/" as the
    reference's ``_path_str`` joins JAX's key path."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(path), tree)


# rule: (regex on path suffix, logical spec per dim)
# logical names: "tp" (model), "fsdp" (data), None.
_PARAM_RULES = [
    (r"embed/tok$", ("tp", "fsdp")),
    (r"embed/head$", ("fsdp", "tp")),
    (r"embed/pos$", (None, "tp")),
    (r"(attn|xattn)/wq$", ("fsdp", "tp", None)),
    (r"(attn|xattn)/wk$", ("fsdp", "tp", None)),
    (r"(attn|xattn)/wv$", ("fsdp", "tp", None)),
    (r"(attn|xattn)/wo$", ("tp", None, "fsdp")),
    (r"mlp/w_in$", ("fsdp", "tp")),
    (r"mlp/w_out$", ("tp", "fsdp")),
    (r"moe/router$", (None, None)),
    (r"moe/w_in$", ("ep", "fsdp", None)),
    (r"moe/w_out$", ("ep", None, "fsdp")),
    # rwkv time-mix / channel-mix
    (r"tm_cm/w[rkvg]$", ("fsdp", "tp")),
    (r"tm_cm/wo$", ("tp", "fsdp")),
    (r"tm_cm/decay_A$", ("fsdp", None)),
    (r"tm_cm/decay_B$", (None, "tp")),
    (r"tm_cm/ln_scale$", ("tp", None)),
    (r"tm_cm/cm_k$", ("fsdp", "tp")),
    (r"tm_cm/cm_v$", ("tp", "fsdp")),
    (r"tm_cm/cm_r$", ("fsdp", None)),
    # griffin
    (r"rec/w_gate$", ("fsdp", "tp")),
    (r"rec/w_in$", ("fsdp", "tp")),
    (r"rec/conv_w$", (None, "tp")),
    (r"rec/conv_b$", ("tp",)),
    (r"rec/gate_[ax]$", ("tp", None, None)),
    (r"rec/lam$", ("tp",)),
    (r"rec/w_out$", ("tp", "fsdp")),
]


def _resolve(
    logical: Optional[str],
    dim: int,
    sizes: Dict[str, int],
    fsdp_axes: Tuple[str, ...],
    model_axis: str,
    ep_axes: Tuple[str, ...] = ("model",),
) -> Any:
    if logical is None:
        return None
    if logical == "tp":
        ax = model_axis
        if ax in sizes and dim % sizes[ax] == 0:
            return ax
        return None
    if logical == "ep":
        usable = tuple(a for a in ep_axes if a in sizes)
        total = math.prod(sizes[a] for a in usable) if usable else 1
        if usable and dim % total == 0:
            return usable if len(usable) > 1 else usable[0]
        return None
    if logical == "fsdp":
        total = math.prod(sizes[a] for a in fsdp_axes if a in sizes)
        usable = tuple(a for a in fsdp_axes if a in sizes)
        if usable and total > 1 and dim % total == 0:
            return usable if len(usable) > 1 else usable[0]
        return None
    raise ValueError(logical)


def param_spec(
    path_s: str,
    shape: Tuple[int, ...],
    mesh,
    *,
    fsdp: bool = True,
    fsdp_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
    ep_axes: Tuple[str, ...] = ("model",),
) -> PartitionSpec:
    sizes = mesh_shape(mesh)
    stacked = path_s.startswith("groups/") or "encoder/layers/" in path_s
    core_shape = tuple(shape[1:] if stacked else shape)
    spec: Optional[Tuple] = None
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path_s):
            if len(logical) != len(core_shape):
                spec = None  # shape mismatch (e.g. un-stacked scalar) -> replicate
                break
            spec = tuple(
                _resolve(
                    l if (fsdp or l != "fsdp") else None,
                    d, sizes, fsdp_axes, model_axis, ep_axes,
                )
                for l, d in zip(logical, core_shape)
            )
            break
    if spec is None:
        spec = (None,) * len(core_shape)
    # drop duplicate axis uses (e.g. "data" in both ep_axes and fsdp_axes)
    seen = set()
    cleaned = []
    for s_ in spec:
        axes = _entry_axes(s_)
        if any(a in seen for a in axes):
            cleaned.append(None)
        else:
            seen.update(axes)
            cleaned.append(s_)
    spec = tuple(cleaned)
    if stacked:
        spec = (None,) + spec
    return P(*spec)


def param_shardings(
    params_shape: Any,
    mesh,
    *,
    fsdp: bool = True,
    fsdp_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
    ep_axes: Tuple[str, ...] = ("model",),
):
    """Tree of :class:`Sharding` matching a params(-shaped) tree: its leaves
    need only a ``shape`` (tensors on the meta device will do)."""

    def one(path_s, leaf):
        spec = param_spec(path_s, tuple(leaf.shape), mesh, fsdp=fsdp, fsdp_axes=fsdp_axes,
                          model_axis=model_axis, ep_axes=ep_axes)
        return Sharding(mesh, spec)

    return map_with_path(one, params_shape)


# --------------------------------------------------------------------------
# Split compute: the leaves whose products split over the model axis.
# --------------------------------------------------------------------------

# attention's projections (self- and cross-attention's), the dense MLP (not
# the experts'), RWKV's time-mix and channel-mix products, the RG-LRU block,
# and the vocabulary: a step computes with the rank's block of these over
# the model axis (``sharding.tp``); it gathers any other leaf whole, and
# these too where the axis left them whole.  RWKV's whole ``decay_A`` and
# ``cm_r`` and the RG-LRU's whole gates are narrowed to the rank's block
# inside the layer (``tp.model_block``, ``griffin.block_columns``)
SPLIT_COMPUTE = re.compile(r"(^|/)(x?attn/w[qkvo]|mlp/w_(in|out)|embed/(tok|head)|"
                           r"tm_cm/(w[rkvgo]|decay_B|ln_scale|cm_[kv])|"
                           r"rec/(w_gate|w_in|conv_[wb]|lam|w_out|gate_[ax]))$")
# the leaves whose products a decode step computes on the rank's FSDP block
# over the data axes where its batch does not split over them
# (``compute_shardings``' ``keep_axes``), as the reference's GSPMD does at
# ``long_500k``: attention's projections, the dense MLP, RWKV's time-mix and
# channel-mix matrices and decay_A, the RG-LRU block's three matrices and
# the vocabulary.  The experts' weights, cross-attention's and the leaves
# with no FSDP dim are gathered over the data axes as in every other step
DATA_SPLIT_COMPUTE = re.compile(r"(^|/)(attn/w[qkvo]|mlp/w_(in|out)|embed/(tok|head)|"
                                r"tm_cm/(w[rkvgo]|decay_A|cm_[kvr])|rec/(w_gate|w_in|w_out))$")
# leaves whose blocks a layer computes with only together: where one of a
# group is left whole over the model axis, every split-compute leaf of the
# layer is gathered whole.  RWKV's ln_scale splits exactly where its heads
# divide the axis, so a time-mix whose column blocks would cut a head
# computes whole.  The RG-LRU's gates are not of its group: stored whole
# where their 8 blocks do not divide the axis, the layer narrows them
_TOGETHER = {"mlp": ("w_in", "w_out"),
             "tm_cm": ("wr", "wk", "wv", "wg", "wo", "decay_B", "ln_scale", "cm_k", "cm_v"),
             "rec": ("w_gate", "w_in", "conv_w", "conv_b", "lam", "w_out")}


@dataclasses.dataclass(frozen=True)
class ComputeSharding:
    """How a step computes with a leaf stored by ``storage``: it gathers the
    leaf by ``gather`` (the storage spec, or for a leaf split in compute the
    storage spec without the model axis: only the FSDP axes), and where
    ``exchange`` (a gated MLP's ``w_in`` split over the model axis) turns
    the storage block's contiguous [gate | up] columns into the compute
    block, the rank's gate columns beside the same up columns."""

    storage: Sharding
    gather: Sharding
    exchange: bool = False
    model_axis: str = "model"

    def to_compute(self, block: torch.Tensor) -> torch.Tensor:
        """The tensor the step computes with, from this rank's storage block.
        Collective."""
        out = self.gather.gather(block)
        if self.exchange:
            from repro_torch.sharding import tp

            out = tp.gated_to_compute(out, self.storage.mesh, self.model_axis)
        return out

    def to_storage(self, grad: torch.Tensor) -> torch.Tensor:
        """This rank's storage block of ``grad``, a gradient of the compute
        tensor already summed over the data axes.  Collective where
        ``exchange``."""
        out = self.gather.shard(grad)
        if self.exchange:
            from repro_torch.sharding import tp

            out = tp.gated_to_storage(out, self.storage.mesh, self.model_axis)
        return out


def _without(spec: PartitionSpec, axis: str) -> PartitionSpec:
    def entry(e):
        kept = tuple(a for a in _entry_axes(e) if a != axis)
        return None if not kept else kept if isinstance(e, tuple) else kept[0]

    return P(*(entry(e) for e in spec))


def _keeping(spec: PartitionSpec, axes: Tuple[str, ...]) -> PartitionSpec:
    """``spec`` without its entries split over ``axes`` alone: gathering with
    it leaves those dims as the rank's block."""
    return P(*(None if _entry_axes(e) and set(_entry_axes(e)) <= set(axes) else e
               for e in spec))


def compute_shardings(shardings: Any, *, gated: bool, model_axis: str = "model",
                      keep_axes: Tuple[str, ...] = ()):
    """A tree of :class:`ComputeSharding` over a tree of storage
    :class:`Sharding` (``param_shardings``'s).  A leaf of ``SPLIT_COMPUTE``
    split over ``model_axis`` keeps its model block; the leaves of a group
    of ``_TOGETHER`` keep theirs only together, and the layer's other
    split-compute leaves only with them (an FF width whose 2·ff divides the
    axis but ff does not computes whole; so does an RWKV layer whose heads
    do not divide it, and an RG-LRU block whose width does not).
    ``gated``: the config's MLP is gated, its ``w_in`` [gate | up].
    ``keep_axes`` (the data axes of a decode step that computes on the FSDP
    blocks, ``DistContext.data_split``): a leaf of ``DATA_SPLIT_COMPUTE``
    also keeps its block over them, where its FSDP dim is split over them
    alone; a leaf whose blocks are all kept is not gathered at all."""
    by_path: Dict[str, Sharding] = {}
    map_with_path(by_path.__setitem__, shardings)

    def split(path: str) -> bool:
        return bool(SPLIT_COMPUTE.search(path)) and any(
            model_axis in _entry_axes(e) for e in by_path[path].spec)

    def one(path: str, s: Sharding) -> ComputeSharding:
        keep = split(path)
        base, _, leaf = path.rpartition("/")
        group = _TOGETHER.get(base.rpartition("/")[2], ())
        if keep and group:
            keep = all(split(f"{base}/{w}") for w in group)
        spec = _without(s.spec, model_axis) if keep else s.spec
        if keep_axes and DATA_SPLIT_COMPUTE.search(path):
            spec = _keeping(spec, keep_axes)
        return ComputeSharding(s, s if spec == s.spec else Sharding(s.mesh, spec),
                               exchange=keep and gated and path.endswith("mlp/w_in"),
                               model_axis=model_axis)

    return map_with_path(one, shardings)


def _compute_layout(c: ComputeSharding) -> tuple:
    """What the compute tensor of ``c`` keeps split: each dim's storage axes
    that the gather leaves, and whether the gated exchange applies."""
    return (tuple(tuple(a for a in _entry_axes(s) if a not in _entry_axes(g))
                  for s, g in zip(c.storage.spec, c.gather.spec)), c.exchange)


def moment_compute_shardings(opt_sh: Any, shardings: Any, *, gated: bool,
                             model_axis: str = "model"):
    """``compute_shardings`` of the AdamW moments (``opt_sh``: an
    ``AdamWState`` of shardings, or the moments' tree) stored apart from the
    parameters (``shardings``), as under ZeRO-1 (``--opt-fsdp-axes``) or
    ``--no-fsdp``: its ``to_storage`` cuts a moment block out of a
    compute-layout tensor and its ``to_compute`` gathers one back.  Only
    the FSDP axes may differ: raises a ``ValueError`` naming the leaf whose
    moments would compute in another layout than its parameter (another
    model block or another exchange)."""
    mu = getattr(opt_sh, "mu", opt_sh)
    plan = compute_shardings(mu, gated=gated, model_axis=model_axis)
    params: Dict[str, ComputeSharding] = {}
    map_with_path(params.__setitem__,
                  compute_shardings(shardings, gated=gated, model_axis=model_axis))

    def check(path: str, c: ComputeSharding) -> None:
        if _compute_layout(c) != _compute_layout(params[path]):
            raise ValueError(
                f"{path}: the moments ({c.storage.spec}) compute as "
                f"{_compute_layout(c)}, the parameter ({params[path].storage.spec}) as "
                f"{_compute_layout(params[path])}; only their FSDP axes may differ")

    map_with_path(check, plan)
    return plan


# --------------------------------------------------------------------------
# Optimizer state: moments shard like params; step is replicated.
# --------------------------------------------------------------------------

def opt_shardings(params_shape, mesh, **kw):
    from repro_torch.optim.adamw import AdamWState

    p_sh = param_shardings(params_shape, mesh, **kw)
    return AdamWState(step=Sharding(mesh, P()), mu=p_sh, nu=p_sh)


def init_opt_blocks(opt_sh, params_shape, device):
    """A fresh AdamW state of this rank's blocks by ``opt_sh``
    (``opt_shardings``'s) on ``device``: f32 zero moments, step 0.  On the
    meta device nothing is allocated."""
    from repro_torch.models.convert import tree_map2
    from repro_torch.optim.adamw import AdamWState

    def zeros(s: Sharding, t) -> torch.Tensor:
        shape = s.block(torch.empty(tuple(t.shape), device="meta")).shape
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map2(zeros, opt_sh.mu, params_shape),
                      nu=tree_map2(zeros, opt_sh.nu, params_shape))


# --------------------------------------------------------------------------
# Decode-cache shardings.
# --------------------------------------------------------------------------

def cache_shardings(
    caches_shape: Any,
    mesh,
    *,
    dp_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
    seq_axis: str = "data",
):
    """KV caches: batch over dp when divisible, else the *sequence* dim
    shards over ``seq_axis`` (long-context, batch=1); KV heads / recurrent
    widths over "model" when divisible."""
    sizes = mesh_shape(mesh)
    dp_total = math.prod(sizes[a] for a in dp_axes if a in sizes)

    def one(path_s, leaf):
        shp = tuple(leaf.shape)  # leading dim = layer count (stacked)
        m = sizes.get(model_axis, 1)

        def div(i, ax_size):
            return shp[i] % ax_size == 0 and ax_size > 1

        if re.search(r"/(k|v|ck|cv)$", path_s) and len(shp) == 5:
            # (count, B, cap, G, dh)
            b_ax = dp_axes if div(1, dp_total) else None
            s_ax = None
            if b_ax is None and div(2, sizes.get(seq_axis, 1)):
                s_ax = seq_axis
            g_ax = model_axis if div(3, m) else None
            return Sharding(mesh, P(None, b_ax, s_ax, g_ax, None))
        if path_s.endswith("state") and len(shp) == 5:  # rwkv (count,B,H,K,V)
            b_ax = dp_axes if div(1, dp_total) else None
            h_ax = model_axis if div(2, m) else None
            return Sharding(mesh, P(None, b_ax, h_ax, None, None))
        if re.search(r"(tm_shift|cm_shift|h)$", path_s) and len(shp) == 3:
            b_ax = dp_axes if div(1, dp_total) else None
            d_ax = model_axis if div(2, m) else None
            return Sharding(mesh, P(None, b_ax, d_ax))
        if path_s.endswith("conv") and len(shp) == 4:  # (count,B,w,W)
            b_ax = dp_axes if div(1, dp_total) else None
            d_ax = model_axis if div(3, m) else None
            return Sharding(mesh, P(None, b_ax, None, d_ax))
        return Sharding(mesh, P(*([None] * len(shp))))

    return map_with_path(one, caches_shape)


def batch_sharding(mesh, batch: int, ndim: int, dp_axes: Tuple[str, ...]) -> Sharding:
    sizes = mesh_shape(mesh)
    dp_total = math.prod(sizes[a] for a in dp_axes if a in sizes)
    lead = dp_axes if (dp_total > 1 and batch % dp_total == 0) else None
    return Sharding(mesh, P(lead, *([None] * (ndim - 1))))
