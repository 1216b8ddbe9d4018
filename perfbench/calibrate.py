"""The readings a cell's correctness limits are set from, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 [--out PATH]

For each seed: the cell's weights, then as many batches of its traffic as
its sample needs, served as the timed path serves them; the sample's
served tokens against the float32 reference (the program's reading).  For
each control seed also the control: the reference with every weight product
in float8 e4m3 (``reference.precision.fp8_linear``), read as the gap of the
token it ranks first at each position of the same sequences.  The weights'
layout and the reference are the configuration's own module's
(``Spec.reference``: ``perfbench/reference/<name>.py``), as in a run; a new
configuration needs nothing here.  Prints one
line a seed with the widest and the mean gap and the share of tokens off
the reference's argmax (``check.numbers``), and writes them as JSON.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def stats(gaps: np.ndarray) -> dict:
    from perfbench.check import numbers

    return dict(numbers(gaps), tokens=int(gaps.size))


def readings(cell_name: str, seeds, control_seeds, device="cuda", root: Path = ROOT) -> dict:
    from perfbench import check, serving, weights
    from perfbench.harness import port_config
    from perfbench.spec import Spec

    spec = Spec(root, root / "perfbench")
    cell = spec.cell(cell_name)
    model, traffic = cell.config["model"], cell.traffic
    reference = spec.reference(model)
    cfg = port_config(model)
    n_batches = -(-traffic["check_requests"] // traffic["batch"])
    out = {"cell": cell_name, "program": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        params = weights.draw(reference, model, seed, device)
        server = serving.Server(cfg, params, traffic, model, seed, device)
        batches = [server.batch(i) for i in range(n_batches)]
        del server
        chosen = check.sample(batches, traffic["batch"], traffic["check_requests"], seed)
        seqs, served = check.sequences(batches, chosen, traffic, model, seed, device)
        if seed in seeds:
            out["program"][seed] = stats(
                check.served_gaps(reference, model, params, seqs, served,
                                  traffic["prompt_len"]))
        if seed in control_seeds:
            out["control"][seed] = stats(
                check.control_gaps(reference, model, params, seqs, traffic["prompt_len"]))
        line = {k: out[k].get(seed) for k in ("program", "control")}
        print(f"seed {seed} ({time.perf_counter() - t0:.1f} s): {json.dumps(line)}", flush=True)
        del params, seqs, served, batches
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    out = readings(args.workload, ints(args.seeds), ints(args.control_seeds))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
