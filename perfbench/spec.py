"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``perfbench/`` a cell's configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``), its
correctness limits (``checks/<cell>.json``), each metric's reader
(``metrics/<metric>.py``) and the model's own code
(``reference/<name>.py``, with its counts ``work/<WORK>.py``).  A
configuration, a traffic mix, a metric or a cell is added with new files
and new entries; no code here names one.

A new configuration adds its file under ``configs/``; where the model
section's ``"reference"`` (``decoder`` where absent) names a module that
does not cover it, a new ``reference/<name>.py`` with the four names of
``reference``'s contract, and a new ``work/<name>.py`` where
``work/serve.py`` does not count it."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
REFERENCE = "decoder"  # the model's module where its section names none


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


def _load(path: Path, name: str) -> ModuleType:
    """The module at ``path``, as ``name``; fails with the path where there
    is no file."""
    if not path.is_file():
        raise FileNotFoundError(f"no module {name!r}: looked for {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.bench = _json(self.root / "BENCHMARK.json")
        self._references: Dict[str, ModuleType] = {}

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
        module = _load(path, "perfbench.metrics." + name)
        run = "plain" if metric in self.bench["end_to_end"] else "traced"
        declared = (module.UNIT, module.RUN, module.SOURCE)
        if declared != (metric["unit"], run, metric["source"]):
            raise ValueError(f"{path.name} declares {declared}, BENCHMARK.json "
                             f"{(metric['unit'], run, metric['source'])}")
        return module

    def readers(self, metrics: List[dict]) -> Dict[str, object]:
        return {m["name"]: self.reader(m) for m in metrics}

    def reference(self, model: dict) -> ModuleType:
        """The code of ``model`` (a configuration file's ``model`` section):
        ``reference/<name>.py``, the name its ``"reference"`` or
        ``decoder``.  The module gives ``layout(model)`` and
        ``absent(model)``, the leaves the benchmark draws
        (``weights.draw``) and the paths the port holds as None;
        ``logits(model, params, tokens, first, linear)``, the plain float32
        reference (``check``); and ``WORK``, the name of its counts module
        ``work/<WORK>.py``, loaded here as its ``work`` for the readers.
        Both files are read from this benchmark's own directory."""
        name = model.get("reference", REFERENCE)
        if name not in self._references:
            module = _load(self.dir / "reference" / f"{name}.py", "perfbench.reference." + name)
            module.work = _load(self.dir / "work" / f"{module.WORK}.py",
                                "perfbench.work." + module.WORK)
            self._references[name] = module
        return self._references[name]
