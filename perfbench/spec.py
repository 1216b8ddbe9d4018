"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``perfbench/`` a cell's configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``), its
correctness limits (``checks/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``).  A configuration, a traffic mix, a metric or a
cell is added with new files and new entries; no code here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    checks: dict  # checks/<cell>.json: number -> {"limit": ...}
    end_to_end: List[dict]  # BENCHMARK.json's entries that this cell reports
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Spec:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.bench = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        w = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        config = _json(self.root / configs[w["config"]]["file"])
        return Cell(
            name=name, chips=w["chips"], config=config,
            traffic=_json(self.dir / "traffic" / f"{w['traffic']}.json"),
            checks=_json(self.dir / "checks" / f"{name}.json"),
            end_to_end=[m for m in self.bench["end_to_end"] if _applies(m, name)],
            per_layer=[m for m in self.bench["per_layer"] if _applies(m, name)])

    def reader(self, metric: dict):
        """The module that reads ``metric``: ``metrics/<name>.py`` with its
        ``UNIT``, ``RUN`` ("plain" for an end-to-end metric, "traced" for a
        per-layer one), ``SOURCE`` and ``read(run)``, which returns the
        value or None where the run holds nothing to read."""
        name = metric["name"]
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location("perfbench.metrics." + name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        run = "plain" if metric in self.bench["end_to_end"] else "traced"
        declared = (module.UNIT, module.RUN, module.SOURCE)
        if declared != (metric["unit"], run, metric["source"]):
            raise ValueError(f"{path.name} declares {declared}, BENCHMARK.json "
                             f"{(metric['unit'], run, metric['source'])}")
        return module

    def readers(self, metrics: List[dict]) -> Dict[str, object]:
        return {m["name"]: self.reader(m) for m in metrics}
