"""One run of one cell:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the weights on the device from the seed, builds the port's
configuration from the cell's configuration file and serves one warm batch
of the cell's own shape, prefill and three decode steps over caches of the
traffic's capacity (it loads the kernel libraries, building them with nvcc
the first time in a checkout, captures the decode step once and replays
it).
Then the window: batches back to back for ``--seconds`` (``serving``).  With
``--trace 1`` the window runs under ``torch.profiler`` with the harness's
phases named and every replay timed by CUDA events, and the line carries
the per-layer metrics; with ``--trace 0`` the end-to-end ones.  After the
window the peak memory is read, a traced run's profile is walked once and
read two ways (the device trace, ``devtrace``, and the program's spans,
``spans``, which the readers find as ``Run.trace`` and ``Run.spans``), the
program's state is freed and a sample of the window's requests is judged
against the plain reference (``check``).

The model's own code (the weights' layout, the reference and the counts the
readers use) is the configuration's module (``Spec.reference``), which the
``Run`` carries; nothing here names a model.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (requests served in the window), ``failed`` (sampled requests
that fail a limit), ``metrics``, ``device``, ``breakdown`` when traced, and
last ``checked``: each number compared with its limit, which are also the
last lines on standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import List, Optional, Tuple

import torch

from perfbench import check, devtrace, serving, spans, weights
from perfbench.spec import Cell, Spec
from perfbench.work import peaks as peak_table

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names
WARM_INDEX = -1  # the warm batch's prompts are none of the window's
WARM_STEPS = 3  # step 0 with the capture, then two replays


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    model: dict  # the configuration file's model section
    traffic: dict
    setup_s: float
    window_s: float  # first batch's start to the last batch's last token, host clock
    batches: List[serving.Batch]
    device_name: str
    reference: ModuleType  # the model's module (``Spec.reference``)
    trace: Optional[devtrace.DeviceTrace] = None
    spans: Optional[spans.SpanTrace] = None  # the program's spans, traced runs only

    @property
    def work(self) -> ModuleType:
        """The model's counts (``perfbench/work/<WORK>.py``)."""
        return self.reference.work

    @property
    def peaks(self) -> Optional[dict]:
        """The card's published peaks; None off the card, where no device
        metric is read."""
        return None if self.device_name == "cpu" else peak_table.peaks(self.device_name)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def port_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's model section."""
    from repro_torch.configs.base import LayerGroup, ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in fields and k != "groups"}
    groups = tuple(LayerGroup(pattern=tuple(g["pattern"]), count=g["count"])
                   for g in model["groups"])
    return ModelConfig(groups=groups, **kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: Spec, cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Tuple[Run, dict]:
    """One run; returns what its readers read and the result line's object."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    model, traffic = cell.config["model"], cell.traffic
    readers = spec.readers(cell.per_layer if trace else cell.end_to_end)
    reference = spec.reference(model)
    cfg = port_config(model)
    t_draw = time.perf_counter()
    params = weights.draw(reference, model, seed, device)
    _sync(device)
    t_warm = time.perf_counter()
    server = serving.Server(cfg, params, traffic, model, seed, device)
    server.batch(WARM_INDEX, steps=WARM_STEPS)
    _sync(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_start

    prof = None
    with contextlib.ExitStack() as traced:
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = traced.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            traced.enter_context(record_function(devtrace.WINDOW))
        batches = server.window(seconds, first_index=0, instrument=trace)
    window_s = batches[-1].end - batches[0].start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    t_read = time.perf_counter()
    events = devtrace.events(prof, serving.PHASES, spans.HOST_PREFIXES) \
        if prof is not None else None
    del prof
    t_trace = time.perf_counter()
    dtrace = devtrace.trace(events) if events is not None else None
    t_spans = time.perf_counter()
    strace = spans.split(events) if events is not None else None
    t_read_end = time.perf_counter()
    del events, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(cell, model, traffic, setup_s, window_s, batches, name, reference, dtrace, strace)
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = readers[metric["name"]].read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    chosen = check.sample(batches, traffic["batch"], traffic["check_requests"], seed)
    seqs, served = check.sequences(batches, chosen, traffic, model, seed, device)
    gaps = check.served_gaps(reference, model, params, seqs, served, traffic["prompt_len"])
    read = check.numbers(gaps)
    checked, failed = check.judge(read, cell.checks, len(chosen))

    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    out = {"correct": failed == 0, "attempted": len(batches) * traffic["batch"],
           "failed": failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"], dev["window_s"] = dtrace.busy_s, dtrace.window_s
        out["breakdown"] = {"device_ops": [list(kv) for kv in dtrace.top_ops()],
                            "idle_gaps": [list(kv) for kv in dtrace.top_idle()]}
    walls = sorted(b.end - b.start for b in batches)
    firsts = sorted(b.first_step_s for b in batches)
    print(f"perfbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s (before the draw "
          f"{t_draw - t_start:.3f}, the draw {t_warm - t_draw:.3f}, the warm batch "
          f"{t_end - t_warm:.3f}), {len(batches)} batches "
          f"in {window_s:.3f} s, a batch {walls[0]:.4f}/{walls[len(walls) // 2]:.4f}/"
          f"{walls[-1]:.4f} s, step 0 and capture {firsts[0] * 1e3:.1f}/"
          f"{firsts[len(firsts) // 2] * 1e3:.1f}/{firsts[-1] * 1e3:.1f} ms (min/median/max), "
          f"peak {peak / 1e9:.3f} GB; the profile's events read {t_trace - t_read:.3f} s, "
          f"the device trace {t_spans - t_trace:.3f} s, the spans {t_read_end - t_spans:.3f} s; "
          f"in order, batch s "
          f"{[round(float(b.end - b.start), 3) for b in batches]}, step 0 and capture ms "
          f"{[round(b.first_step_s * 1e3, 1) for b in batches]}", file=sys.stderr)
    out["observed"] = {k: v for k, v in read.items() if k not in checked}
    out["checked"] = checked
    return run, out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = Spec(Path(__file__).resolve().parents[1])
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    _, out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    for number, value in out["observed"].items():
        print(f"observed {number} {value!r} (no limit)", file=sys.stderr)
    for number, c in out["checked"].items():
        print(f"checked {number} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
