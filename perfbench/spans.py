"""The program's own spans in a traced window: device time and idle by the
port's layer, read from the profiler's raw events on the device trace's
clock.

The port names its work with ``obs.trace`` spans, which are profiler
ranges while a profiler records (``models/decode.py``): ``model.*`` inside
prefill and the decode step, ``graph.*`` around step 0 and the capture.  A
span's key is its path, the program spans around it from the outermost
down (``graph.warmup/model.decode_step/model.attention``).

A device operation (as ``devtrace`` counts them, clipped to the window) is
matched by ``correlation_id()`` to the runtime call that launched it
(``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cuLaunchKernel``, ...) and
charged to the innermost program span open at that call; one launched
outside every program span, a graph replay's among them, goes to
``NONE``.  The harness launches from one host thread, so a span holds
what was launched between its ends.  An idle gap of 20 us or more goes to
the innermost program span that holds its midpoint, else to the harness's
phase by ``devtrace``'s rule.

The harness's traced run reads them once the window has closed and hands
them to the metrics' readers as ``Run.spans`` (``layer_ms`` gives the
per-layer device times), so a reader can read any span the port adds.
One traced window of a cell with the whole split, from the root of a
checkout:

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs ``harness.run_cell`` as ``--trace 1`` does and prints one JSON line:
the result line's object under ``run`` and, under ``layers``, the split
(``summary``).
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import devtrace  # noqa: E402

PREFIXES = ("model.", "graph.")  # the program's span names
NONE = "(none)"
LAUNCH = ("cuda", "cu")  # host calls that launch: cudaLaunchKernel, cuLaunchKernel, ...
HOST_PREFIXES = PREFIXES + LAUNCH  # the host events ``split`` reads
PREFILL = "model.prefill"
STEP0 = "graph.warmup/model.decode_step"  # step 0, the eager run of the captured step
LAYERS = ("model.attention", "model.ffn")
COVERED = LAYERS + ("model.head",)


@dataclasses.dataclass
class SpanTrace:
    op_seconds: Dict[str, float]  # device seconds by the launching span's path
    op_counts: Dict[str, int]  # device operations by the same
    calls: Dict[str, int]  # times each span path opened in the window
    host_seconds: Dict[str, float]  # host seconds by span path
    idle: Dict[str, float]  # idle seconds by span path, else by harness phase
    unlaunched_s: float = 0.0  # device seconds whose launch the profile did not record
    by_name: Dict[Tuple[str, str], float] = dataclasses.field(default_factory=dict)
    # device seconds by (span path, operation name)

    def under(self, path: str) -> float:
        """Device seconds of the operations launched under ``path``, its
        own and those of the spans inside it."""
        return sum(s for p, s in self.op_seconds.items()
                   if p == path or p.startswith(path + "/"))

    def per_call(self, path: str, per: str) -> Optional[float]:
        """``under(path)`` over the times ``per`` opened; None where it never did."""
        n = self.calls.get(per, 0)
        return self.under(path) / n if n else None

    def coverage(self, parent: str) -> Optional[float]:
        """The share of ``parent``'s device time launched under its ``COVERED`` spans."""
        whole = self.under(parent)
        return sum(self.under(f"{parent}/{c}") for c in COVERED) / whole if whole else None

    def top_idle(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.idle.items(), key=lambda kv: -kv[1])[:n]


def _with_paths(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """(start, end, path) of nested spans sorted by (start, -end)."""
    out, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][0] <= s:
            stack.pop()
        path = f"{stack[-1][1]}/{name}" if stack else name
        stack.append((e, path))
        out.append((s, e, path))
    return out


def _innermost(spans: List[Tuple[int, int, str]], times: List[int]) -> List[Optional[str]]:
    """The path of the innermost span open at each of the sorted ``times``."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][0] <= spans[j][0]:
                stack.pop()
            stack.append((spans[j][1], spans[j][2]))
            j += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        out.append(stack[-1][1] if stack else None)
    return out


def read(prof, phases) -> SpanTrace:
    """The program's spans of ``prof`` inside ``devtrace.WINDOW``;
    ``phases`` are the harness's host phase names."""
    return split(devtrace.events(prof, phases, HOST_PREFIXES))


def split(ev: devtrace.Events) -> SpanTrace:
    """The program's spans of a profile's events (``devtrace.events`` with
    ``HOST_PREFIXES`` kept)."""
    spans = [(s, e, n) for s, e, n, _, _ in ev.host if n.startswith(PREFIXES)]
    launches = {c: s for s, _, n, c, annotation in ev.host
                if n.startswith(LAUNCH) and not annotation}
    host, device = ev.phases, ev.device
    ws, we = ev.window
    spans = _with_paths(sorted((s, e, n) for s, e, n in spans if e > ws and s < we))
    calls: Dict[str, int] = {}
    host_seconds: Dict[str, float] = {}
    for s, e, path in spans:
        calls[path] = calls.get(path, 0) + 1
        host_seconds[path] = host_seconds.get(path, 0.0) + (e - s) / 1e9

    device = [(max(s, ws), min(e, we), c, n) for s, e, c, n in device if e > ws and s < we]
    launched = sorted((launches[c], i) for i, (_, _, c, _) in enumerate(device)
                      if c in launches)
    where = [NONE] * len(device)
    for (_, i), path in zip(launched, _innermost(spans, [t for t, _ in launched])):
        where[i] = path or NONE
    unlaunched = sum(e - s for s, e, c, _ in device if c not in launches) / 1e9
    op_seconds: Dict[str, float] = {}
    op_counts: Dict[str, int] = {}
    by_name: Dict[Tuple[str, str], float] = {}
    for (s, e, _, name), path in zip(device, where):
        op_seconds[path] = op_seconds.get(path, 0.0) + (e - s) / 1e9
        op_counts[path] = op_counts.get(path, 0) + 1
        by_name[path, name] = by_name.get((path, name), 0.0) + (e - s) / 1e9

    busy = devtrace._union([(s, e) for s, e, _, _ in device])
    edges = [ws] + [t for iv in busy for t in iv] + [we]
    gaps = [(gs, ge) for gs, ge in zip(edges[::2], edges[1::2]) if ge > gs]
    long_gaps = [g for g in gaps if g[1] - g[0] >= devtrace.SHORT_GAP_NS]
    inside = _innermost(spans, [(gs + ge) // 2 for gs, ge in long_gaps])
    idle: Dict[str, float] = {}
    for (gs, ge), path in zip(long_gaps, inside):
        if path is not None:
            idle[path] = idle.get(path, 0.0) + (ge - gs) / 1e9
    spanned = {g for g, path in zip(long_gaps, inside) if path is not None}
    rest = [g for g in gaps if g not in spanned]  # short gaps too, as devtrace sums them
    for name, seconds in devtrace._idle_by_phase(rest, host).items():
        idle[name] = idle.get(name, 0.0) + seconds
    return SpanTrace(op_seconds, op_counts, calls, host_seconds, idle, unlaunched, by_name)


def layer_ms(spans: SpanTrace) -> Dict[str, Optional[float]]:
    """Device ms of the layers: prefill's a batch, step 0's a step."""
    out = {}
    for stage, parent in (("prefill", PREFILL), ("decode", STEP0)):
        for layer in LAYERS:
            seconds = spans.per_call(f"{parent}/{layer}", parent)
            out[f"{stage}.{layer.split('.')[1]}_ms"] = \
                None if seconds is None else 1e3 * seconds
    return out


def _top_ops(spans: SpanTrace, path: str, per: str, n: int = 6) -> List[list]:
    """The operations launched under ``path`` itself: [name, device ms a
    call of ``per``], the longest first."""
    calls = spans.calls.get(per, 0) or 1
    ops = [[name, 1e3 * s / calls] for (p, name), s in spans.by_name.items() if p == path]
    return sorted(ops, key=lambda op: -op[1])[:n]


def summary(spans: SpanTrace, trace: devtrace.DeviceTrace) -> dict:
    """What a traced window's spans say, beside the device trace."""
    step0 = spans.per_call(STEP0, STEP0)
    in_graph = sum(s for p, s in spans.idle.items() if p.startswith("graph."))
    step0_idle = trace.idle_by_phase.get("decode.step0", 0.0)
    return {
        "metrics": layer_ms(spans),
        "coverage": {PREFILL: spans.coverage(PREFILL), STEP0: spans.coverage(STEP0)},
        "step0_device_ms": None if step0 is None else 1e3 * step0,
        "unlaunched_s": spans.unlaunched_s,
        "step0_idle_in_graph_spans": in_graph / step0_idle if step0_idle else None,
        "idle_spans": [list(kv) for kv in spans.top_idle()],
        "device_s": sorted(spans.op_seconds.items(), key=lambda kv: -kv[1]),
        "top_ops": {path: _top_ops(spans, path, per)
                    for per in (PREFILL, STEP0)
                    for path in [per] + [f"{per}/{c}" for c in COVERED]},
        "calls": spans.calls,
        "host_ms_a_call": {p: 1e3 * s / spans.calls[p] for p, s in spans.host_seconds.items()},
    }


def main(argv=None) -> int:
    """One traced window of a cell (``harness.run_cell``), read by the spans."""
    t_start = time.perf_counter()
    from perfbench import run  # noqa: F401  (sets the build caches' directories)
    from perfbench import harness
    from perfbench.spec import Spec

    args = harness.parse(argv)
    spec = Spec(Path(__file__).resolve().parents[1])
    cell = spec.cell(args.workload)
    # the replays' CUDA events in every cell, to set step 0 against
    cell.per_layer += [m for m in spec.bench["per_layer"]
                       if m["name"] == "decode.step_ms" and m not in cell.per_layer]
    run, out = harness.run_cell(spec, cell, args.seed, args.seconds, True, "cuda", t_start)
    print(json.dumps({"run": out, "layers": summary(run.spans, run.trace)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
