"""Trip-count-aware HLO cost analysis, and the port's cost counter over a
torch program.

The first half is a copy of ``repro.launch.hlo_analysis`` (the reference's
module imports only ``re``, ``dataclasses``, ``typing`` and numpy), kept as
it is so that the port reads the HLO texts and dry-run records the
reference writes: ``analyze(hlo_text)`` gives the same :class:`HloCost`.

XLA's ``compiled.cost_analysis()`` counts a ``while`` body ONCE, regardless
of trip count — useless for scan-over-layers models where ~L/(L+1) of all
compute lives inside loops.  ``analyze`` parses ``compiled.as_text()``,
builds the computation call graph (entry -> fusions/calls/while bodies),
extracts loop trip counts from the jax-emitted ``while`` conditions
(``compare(counter, constant(N)), direction=LT``), and accumulates:

  * ``dot_flops``        — 2 * prod(out dims) * contracted extent for every
                           dot, times the product of enclosing trip counts
                           (MXU-roofline numerator; elementwise flops are
                           intentionally excluded — they live in the memory
                           term).
  * ``hbm_bytes``        — per top-level op: operand + output bytes (HLO is
                           post-fusion, so fusion operands/outputs are the
                           real HBM transfers), times multiplier.
  * ``collectives``      — output bytes per collective kind, split ICI/DCN
                           by replica-group pod membership, times multiplier.

All numbers are PER DEVICE (the module is the SPMD per-device program).

The second half, :func:`count` and :func:`trace_cost`, fills the same
fields from one eager run of a torch program (meta tensors will do: nothing
is allocated), per rank:

  * ``dot_flops`` — 2 · out · contracted for the matmul family only (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, which ``einsum``, ``linear`` and
    ``matmul`` decompose into), by ``torch.utils.flop_counter``'s formulas.
    Eager runs every loop iteration, so no trip count is needed; the
    recompute of ``torch.utils.checkpoint`` runs during backward under the
    counter, so remat shows as extra flops, as in the reference.
  * ``hbm_bytes`` (with ``bytes_by_kind`` by aten op name and ``top_ops``) —
    each aten op's operand bytes plus its output bytes, a tensor counted at
    its own size (a view's elements, not its storage).  Views and ops that
    only allocate count 0; gathers that copy (``index``, ``index_select``,
    ``gather``, ``embedding``) count 2 × output; a write into part of a
    buffer in place (``copy_`` into a view, ``index_copy_``, ``index_put_``,
    ``scatter_``, ``index_add_``) counts the update twice, not the buffer,
    the analogue of the reference's dynamic-update-slice.  Eager has no
    fusion, so this count is larger than XLA's post-fusion count: every
    intermediate of an elementwise chain goes through memory here.
  * ``collectives`` — every call of ``comms.routes``' five primitives (each
    collective of the port goes through them) while the counter is active:
    count, and the output bytes as ICI or DCN.  A call is DCN when the
    global ranks of its group lie in more than one pod (pod =
    rank // ``chips_per_pod``), the reference's ``_spans_pod`` on real rank
    lists; for ``send_recv`` the ranks are this rank and its peers.

Kernels are opaque to the counter: a hand-written kernel is a ``ctypes``
launch, not an aten op.  So the counter raises when any kernel's
``launches`` counter moves while it counts, rather than report an
undercount.
"""
from __future__ import annotations

import dataclasses
import importlib
import re
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_EXPL_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
# type text may contain `/*index=N*/` comments inside tuples; capture lazily
# up to the first `<op-kind>(` token.
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s([\w\-]+)\(")
_CALLED = re.compile(r"(?:calls|body|condition|to_apply|branch_computations)=.?%?([\w.\-{}, ]+)")


def _shape_list(txt: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(txt):
        if dt in DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(txt: str) -> int:
    total = 0
    for dt, dims in _shape_list(txt):
        total += int(np.prod(dims)) * DTYPE_BYTES[dt] if dims else DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class Op:
    name: str
    out_txt: str
    kind: str
    rest: str  # text after the opening paren (operands + attributes)


@dataclasses.dataclass
class Computation:
    name: str
    ops: List[Op]


def parse_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for raw in hlo.splitlines():
        line = raw.rstrip()
        if cur is None:
            s = line.strip()
            if s.endswith("{") and "->" in s:
                m = _COMP_HDR.match(s)
                if m:
                    cur = Computation(m.group(1), [])
            continue
        if line.strip() == "}":
            comps[cur.name] = cur
            cur = None
            continue
        m = _OP_RE.match(line)
        if m:
            cur.ops.append(Op(m.group(1), m.group(2), m.group(3), line[m.end():]))
    return comps


def _called_comps(op: Op) -> List[str]:
    names: List[str] = []
    for m in re.finditer(r"(calls|body|condition|to_apply)=%?([\w.\-]+)", op.rest):
        names.append(m.group(2))
    m = re.search(r"branch_computations=\{([^}]*)\}", op.rest)
    if m:
        names += [x.strip().lstrip("%") for x in m.group(1).split(",")]
    return names


def _trip_count(cond: Computation) -> int:
    """Max integer constant in the while condition = jax scan trip count."""
    best = 1
    for op in cond.ops:
        if op.kind == "constant":
            m = re.match(r"(\d+)\)?", op.rest)
            if m:
                best = max(best, int(m.group(1)))
    return best


def _dot_flops(op: Op, comps: Dict[str, Computation], comp: Computation) -> float:
    """2 * prod(output dims) * contracted extent.  Contracted extent from
    lhs shape + dimension numbers."""
    out_dims = []
    for _, dims in _shape_list(op.out_txt):
        out_dims = dims
        break
    out_elems = float(np.prod(out_dims)) if out_dims else 1.0
    # operands appear as %name at the start of rest; their shapes are inline:
    shapes = _shape_list(op.rest.split("dim_labels")[0])
    m = re.search(r"lhs_contracting_dims=\{([\d,]+)\}", op.rest)
    if shapes and m:
        lhs_dims = shapes[0][1]
        contract = 1
        for i in [int(x) for x in m.group(1).split(",")]:
            if i < len(lhs_dims):
                contract *= lhs_dims[i]
        return 2.0 * out_elems * contract
    # fallback: operand shapes not inline (common in optimized HLO): look up
    # the producing op in the same computation.
    opnd = re.match(r"\s*%?([\w.\-]+)", op.rest)
    if m and opnd:
        for o2 in comp.ops:
            if o2.name == opnd.group(1):
                lhs = _shape_list(o2.out_txt)
                if lhs:
                    contract = 1
                    for i in [int(x) for x in m.group(1).split(",")]:
                        if i < len(lhs[0][1]):
                            contract *= lhs[0][1][i]
                    return 2.0 * out_elems * contract
    return 2.0 * out_elems  # last resort


def _sliced_params(comp: Computation) -> Dict[int, int]:
    """Parameters of a (fused) computation that are only read through a
    dynamic-slice/gather: param index -> slice output bytes.  A fusion whose
    kernel slices a huge operand (decode KV caches!) reads only the slice."""
    param_idx: Dict[str, int] = {}
    for o in comp.ops:
        if o.kind == "parameter":
            m = re.match(r"(\d+)\)?", o.rest)
            if m:
                param_idx[o.name] = int(m.group(1))
    sliced: Dict[int, int] = {}
    direct_use: Dict[str, int] = {n: 0 for n in param_idx}
    for o in comp.ops:
        if o.kind == "parameter":
            continue
        args = o.rest.split("),")[0]
        names = re.findall(r"%([\w.\-]+)", args)
        for j, nm in enumerate(names):
            if nm in param_idx:
                if o.kind in ("dynamic-slice", "gather", "slice") and j == 0:
                    idx = param_idx[nm]
                    sliced[idx] = sliced.get(idx, 0) + _shape_bytes(o.out_txt)
                else:
                    direct_use[nm] += 1
    # only params with NO non-slice uses qualify
    return {
        idx: b
        for nm, idx in param_idx.items()
        for b in [sliced.get(idx)]
        if b is not None and direct_use.get(nm, 0) == 0
    }


def _dus_fusion_bytes(op: Op, comp: Computation, comps: Dict[str, Computation]) -> Optional[int]:
    """In-place update fusions: a fused computation whose root is a
    dynamic-update-slice updating a parameter-shaped buffer (scan stack
    writes, KV-cache writes) only moves ~2x the update slice, not the whole
    buffer.  Returns total traffic or None if not such a fusion."""
    for cn in _called_comps(op):
        c = comps.get(cn)
        if c is None:
            continue
        dus = [o for o in c.ops if o.kind == "dynamic-update-slice"]
        if not dus:
            continue
        # fusion output must be buffer-shaped (same as the DUS output)
        if _shape_bytes(op.out_txt) != sum(_shape_bytes(o.out_txt) for o in dus):
            continue
        params = {o.name: _shape_bytes(o.out_txt) for o in c.ops if o.kind == "parameter"}
        total = 0
        buf_bytes = 0
        for o in dus:
            args = o.rest.split("),")[0]
            names = re.findall(r"%([\w.\-]+)", args)
            upd = 0
            if len(names) >= 2:
                upd = params.get(names[1], 0)
                if upd == 0:
                    by_name = {x.name: x for x in c.ops}
                    prod = by_name.get(names[1])
                    upd = _shape_bytes(prod.out_txt) if prod else 0
            if upd == 0:
                return None
            total += 2 * upd
            buf_bytes += params.get(names[0], _shape_bytes(o.out_txt))
        # other (non-buffer) operands of the fusion still stream in
        other = _op_operand_bytes(op, comp, comps) - buf_bytes
        return total + max(other, 0)
    return None


def _op_operand_bytes(
    op: Op, comp: Computation, comps: Optional[Dict[str, Computation]] = None
) -> int:
    """Bytes of named operands (resolved against producer output shapes).
    For fusions, operands that the fused kernel only dynamic-slices are
    counted at slice size."""
    total = 0
    # cut attributes: operands come before the first '),' attribute boundary
    args = op.rest.split("),")[0]
    by_name = {o.name: o for o in comp.ops}
    sliced: Dict[int, int] = {}
    if comps is not None and op.kind == "fusion":
        for cn in _called_comps(op):
            if cn in comps:
                sliced.update(_sliced_params(comps[cn]))
    prev_end = 0
    for i, m in enumerate(re.finditer(r"%([\w.\-]+)", args)):
        # inline type annotation (f32[8,16]{1,0} %p.1) sits between the
        # previous operand and this name; use it only when the producer is
        # unknown, else producers + inline types double-count.
        chunk = args[prev_end:m.start()]
        prev_end = m.end()
        if i in sliced:
            total += sliced[i]
            continue
        prod = by_name.get(m.group(1))
        if prod is not None:
            total += _shape_bytes(prod.out_txt)
        elif "[" in chunk:
            total += _shape_bytes(chunk)
    return total


def _operand_shape_bytes(op: Op, comp: Computation, index: int) -> int:
    """Bytes of the index-th named operand (via its producer's output)."""
    args = op.rest.split("),")[0]
    by_name = {o.name: o for o in comp.ops}
    for i, m in enumerate(re.finditer(r"%([\w.\-]+)", args)):
        if i == index:
            prod = by_name.get(m.group(1))
            return _shape_bytes(prod.out_txt) if prod else 0
    return 0


def _spans_pod(rest: str, chips_per_pod: int) -> bool:
    m = _IOTA_RE.search(rest)
    if m:
        ngroups, gsize = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        perm = [int(x) for x in m.group(4).split(",")] if m.group(4) else None
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if perm:
            ids = ids.transpose(perm)
        groups = ids.reshape(ngroups, gsize)
        pods = groups // chips_per_pod
        return bool((pods != pods[:, :1]).any())
    m = _EXPL_RE.search(rest)
    if m:
        ids = [int(x) for x in m.group(1).split(",")]
        return len({i // chips_per_pod for i in ids}) > 1
    return False


@dataclasses.dataclass
class HloCost:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, dict] = dataclasses.field(
        default_factory=lambda: {
            k: {"count": 0.0, "ici_bytes": 0.0, "dcn_bytes": 0.0}
            for k in COLLECTIVE_KINDS
        }
    )
    # attribution maps for hypothesis-forming: bytes by op kind, and the
    # heaviest individual ops (name, kind, total bytes incl. multiplier)
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    top_ops: list = dataclasses.field(default_factory=list)

    def note_bytes(self, kind: str, name: str, nbytes: float):
        self.hbm_bytes += nbytes
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.top_ops.append((nbytes, kind, name))
        if len(self.top_ops) > 4096:
            self.top_ops.sort(reverse=True)
            del self.top_ops[64:]

    def finalize(self):
        self.top_ops.sort(reverse=True)
        del self.top_ops[24:]
        return self

    def collective_ici_total(self) -> float:
        return sum(v["ici_bytes"] for v in self.collectives.values())

    def collective_dcn_total(self) -> float:
        return sum(v["dcn_bytes"] for v in self.collectives.values())


def analyze(hlo: str, chips_per_pod: int = 256) -> HloCost:
    comps = parse_computations(hlo)
    entry_name = None
    for raw in hlo.splitlines():
        s = raw.strip()
        if s.startswith("ENTRY"):
            m = re.match(r"ENTRY\s+%?([\w.\-]+)", s)
            if m:
                entry_name = m.group(1)
            break
    if entry_name is None or entry_name not in comps:
        # fall back: the computation named main*
        for n in comps:
            if n.startswith("main"):
                entry_name = n
                break
    cost = HloCost()
    seen: set = set()

    def walk(comp_name: str, mult: float):
        if comp_name not in comps:
            return
        comp = comps[comp_name]
        for op in comp.ops:
            if op.kind == "while":
                body = cond = None
                for m in re.finditer(r"(body|condition)=%?([\w.\-]+)", op.rest):
                    if m.group(1) == "body":
                        body = m.group(2)
                    else:
                        cond = m.group(2)
                trips = _trip_count(comps[cond]) if cond in comps else 1
                # while carries its state through HBM each iteration — count
                # the loop-carried tuple traffic once per trip via body ops.
                if body:
                    walk(body, mult * trips)
                continue
            if op.kind in ("fusion", "call", "conditional", "map", "reduce",
                           "reduce-window", "scatter", "sort", "custom-call"):
                for cn in _called_comps(op):
                    # fused computations: count their dots (rare) but not
                    # their elementwise bytes (the fusion op's operands are
                    # the real traffic, added below).
                    if cn in comps:
                        for o2 in comps[cn].ops:
                            if o2.kind == "dot":
                                cost.dot_flops += mult * _dot_flops(o2, comps, comps[cn])
            if op.kind == "dot":
                cost.dot_flops += mult * _dot_flops(op, comps, comp)
            kind = None
            for k in COLLECTIVE_KINDS:
                if op.kind == k or op.kind == k + "-start":
                    kind = k
                    break
            if kind:
                nbytes = _shape_bytes(op.out_txt)
                c = cost.collectives[kind]
                c["count"] += mult
                if _spans_pod(op.rest, chips_per_pod):
                    c["dcn_bytes"] += mult * nbytes
                else:
                    c["ici_bytes"] += mult * nbytes
            # HBM traffic.  Slicing/updating ops only touch the slice, not
            # the (possibly huge, in-place aliased) full operand:
            #   slice-likes: read slice + write slice = 2 x output
            #   dynamic-update-slice: read update + write update (in-place)
            if op.kind in ("slice", "dynamic-slice", "gather"):
                cost.note_bytes(op.kind, op.name, mult * 2 * _shape_bytes(op.out_txt))
            elif op.kind == "dynamic-update-slice":
                upd = _operand_shape_bytes(op, comp, index=1)
                cost.note_bytes(op.kind, op.name,
                                mult * 2 * (upd or _shape_bytes(op.out_txt)))
            elif op.kind == "scatter":
                cost.note_bytes(op.kind, op.name, mult * 2 * _shape_bytes(op.out_txt))
            elif op.kind == "fusion":
                dus = _dus_fusion_bytes(op, comp, comps)
                if dus is not None:
                    cost.note_bytes("fusion-inplace-update", op.name, mult * dus)
                else:
                    cost.note_bytes(op.kind, op.name, mult * (
                        _shape_bytes(op.out_txt) + _op_operand_bytes(op, comp, comps)
                    ))
            elif op.kind not in ("parameter", "constant", "tuple",
                                 "get-tuple-element", "bitcast", "while"):
                cost.note_bytes(op.kind, op.name, mult * (
                    _shape_bytes(op.out_txt) + _op_operand_bytes(op, comp, comps)
                ))

    walk(entry_name, 1.0)
    return cost.finalize()


# --------------------------------------------------------------------------
# The port's counter: the same fields from one eager run of a torch program.
# --------------------------------------------------------------------------

# comms.routes' primitives -> the reference's HLO collective kinds
ROUTE_KINDS = {
    "all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
    "all_gather": "all-gather", "all_to_all": "all-to-all",
    "send_recv": "collective-permute",
}

_aten = torch.ops.aten
# the matmul family; einsum, linear and matmul decompose into these
_MATMULS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
# allocate, or alias without being a view by their schema: no bytes move
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view"}
# gathers that copy what they read: read + write of the output
_SLICE_COPIES = {"index", "index_select", "gather", "embedding"}
# writes into part of its first operand in place: argument index of the update
_PARTIAL_WRITES = {"index_copy_": 3, "index_put_": 2, "scatter_": 3, "scatter_add_": 3,
                   "index_add_": 3}
# torch.distributed's own ops: the routes' observer counts them
_COLLECTIVE_NAMESPACES = {"c10d", "_c10d_functional", "c10d_functional"}


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a tree of dicts, tuples and lists (NamedTuples too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _launches() -> Dict[str, int]:
    """Kernel name -> its wrapper's ``launches`` counter."""
    from repro_torch.kernels.build import KERNELS

    return {n: importlib.import_module(f"repro_torch.kernels.{n}.kernel").launches
            for n in KERNELS}


class _Counter(TorchDispatchMode):
    """Counts every aten op that runs under it into an :class:`HloCost`, an
    estimate of all FLOPs (``flops``: the matmul FLOPs, one per element a
    pointwise op writes and one per element a reduction reads), and the
    peak of live bytes in storages the ops create (``peak_bytes``), which
    weak references release as the program drops them."""

    def __init__(self, chips_per_pod: int, arg_keys: set):
        super().__init__()
        self.cost = HloCost()
        self.chips_per_pod = chips_per_pod
        self.flops = 0.0
        self.arg_keys = arg_keys
        self.live: Dict[int, Tuple[int, Any]] = {}
        self.cur = self.peak_bytes = 0
        self.n = 0

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.arg_keys or key in self.live:
                continue
            self.live[key] = (st.nbytes(), weakref.ref(st, lambda _, k=key: self._release(k)))
            self.cur += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.cur)

    def _release(self, key: int) -> None:
        nbytes, _ = self.live.pop(key, (0, None))
        self.cur -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        self.n += 1
        name = func.overloadpacket.__name__
        if func.overloadpacket in _MATMULS:
            f = float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            self.cost.dot_flops += f
            self.flops += f
        elif torch.Tag.pointwise in func.tags:
            self.flops += max((t.numel() for t in _tensors(out)), default=0)
        elif torch.Tag.reduction in func.tags:
            self.flops += next(_tensors(args)).numel()
        nbytes = self._bytes(func, name, args, kwargs, out)
        if nbytes:
            self.cost.note_bytes(name, f"{name}#{self.n}", float(nbytes))
        self._track(out)
        return out

    @staticmethod
    def _bytes(func, name: str, args, kwargs, out) -> int:
        if func.is_view or name in _FREE:
            return 0
        if name in _SLICE_COPIES:
            return 2 * sum(map(_nbytes, _tensors(out)))
        if name == "copy_":  # into a view or a whole tensor: read src, write dst
            return _nbytes(args[0]) + _nbytes(args[1])
        if name in _PARTIAL_WRITES and len(args) > _PARTIAL_WRITES[name]:
            return 2 * sum(map(_nbytes, _tensors(args[_PARTIAL_WRITES[name]])))
        return (sum(map(_nbytes, _tensors((args, kwargs))))
                + sum(map(_nbytes, _tensors(out))))

    def on_collective(self, op: str, nbytes_in: int, nbytes_out: int, ranks) -> None:
        kind = ROUTE_KINDS[op]
        c = self.cost.collectives[kind]
        c["count"] += 1
        pods = {int(r) // self.chips_per_pod for r in ranks}
        c["dcn_bytes" if len(pods) > 1 else "ici_bytes"] += float(nbytes_out)
        self.n += 1
        self.cost.note_bytes(kind, f"{kind}#{self.n}", float(nbytes_in + nbytes_out))


@dataclasses.dataclass
class Count:
    """One counted run: its :class:`HloCost`, and the record's
    ``cost.flops`` and ``memory`` fields (bytes, per rank)."""

    cost: HloCost
    flops: float  # every FLOP the counter sees, elementwise included
    argument_bytes: int  # the arguments' tensors
    output_bytes: int  # the result's tensors
    temp_bytes: int  # peak of live storages the run created
    alias_bytes: int  # the result's tensors whose storage is an argument's


def trace_cost(fn: Callable, *args, chips_per_pod: int = 256, **kwargs) -> Count:
    """Run ``fn(*args, **kwargs)`` once under the counter and return the
    counts.  Raises when a hand-written kernel launched during the run (its
    work is invisible to the counter), and when another counter is active."""
    from repro_torch.comms import routes

    if routes.observer is not None:
        raise RuntimeError("trace_cost: another cost counter is active")
    arg_keys = {_storage_key(t) for t in _tensors((args, kwargs))}
    counter = _Counter(chips_per_pod, arg_keys)
    before = _launches()
    routes.observer = counter.on_collective
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        routes.observer = None
    moved = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    if moved:
        raise RuntimeError(
            f"trace_cost: kernels launched while counting ({moved}); a CUDA kernel is a "
            "ctypes launch the counter cannot see, so its work would go uncounted: count "
            "with the kernels off (kernels.config.use_kernels(False))")
    outs = list(_tensors(out))
    return Count(
        cost=counter.cost.finalize(),
        flops=counter.flops,
        argument_bytes=sum(map(_nbytes, _tensors((args, kwargs)))),
        output_bytes=sum(map(_nbytes, outs)),
        temp_bytes=counter.peak_bytes,
        alias_bytes=sum(_nbytes(t) for t in outs if _storage_key(t) in arg_keys),
    )


def count(fn: Callable, *args, chips_per_pod: int = 256, **kwargs) -> HloCost:
    """The :class:`HloCost` of one run of ``fn(*args, **kwargs)``, per rank
    (see :func:`trace_cost`)."""
    return trace_cost(fn, *args, chips_per_pod=chips_per_pod, **kwargs).cost
