"""The harness against the benchmark's contract, on the CPU: names and units,
data found by name, a cell added with new files only, the result line's
keys, and no JAX or JAX-package module anywhere in a run."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT, TINY, make_copy, smoke_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        names.append(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_setup_another_metric_and_a_layer():
    from perfbench.spec import Spec

    spec = Spec(ROOT)
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # a layer metric's end-to-end metric is the cell's
            assert m["moves"] in names


def test_each_cells_files_are_found_by_name():
    from perfbench.spec import Spec

    spec = Spec(ROOT)
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench/checks" / f"{w['name']}.json").is_file()
        assert cell.config["name"] == w["config"]
        assert cell.checks and all(c["limit"] > 0 for c in cell.checks.values())
        for m in cell.end_to_end + cell.per_layer:
            module = spec.reader(m)  # raises where the reader disagrees with the entry
            assert callable(module.read)


def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_add_a_config_traffic_metric_and_cell(tmp_path):
    root = tmp_path / "copy"
    root.mkdir()
    make_copy(root)
    before = _tree_digest(ROOT / "perfbench")
    (root / "perfbench/metrics/serve.batches.py").write_text(
        'UNIT, RUN, SOURCE = "count", "traced", "program_counter"\n\n\n'
        "def read(run):\n    return float(len(run.batches))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "serve.batches", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "serving loop",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["tiny-dense.smoke"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = smoke_run(root, "tiny-dense.smoke", trace=True)
    assert out["metrics"]["serve.batches"]["value"] >= 1
    for name in TINY:  # the smoke cells' files are new; nothing of the tree changed
        assert (root / f"perfbench/configs/{name}.json").is_file()
    copied = _tree_digest(root / "perfbench")
    assert all(copied[path] == digest for path, digest in before.items())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contracts_keys(bench_copy, trace):
    out = smoke_run(bench_copy, "tiny-moe.smoke", trace=trace)
    json.dumps(out)
    assert list(out)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 4
    for number in out["checked"].values():
        assert set(number) == {"value", "limit"}
    want = {"serve.plan_us"} if trace else \
        {"setup_s", "serve_tokens_per_s", "serve_itl_p95_ms"}
    assert set(out["metrics"]) == want  # device metrics are not read off the card
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    sources = [p for p in (ROOT / "perfbench").rglob("*.py") if "tests" not in p.parts]
    for path in sources:
        assert not _imports(path) & FORBIDDEN, path
    reference = (ROOT / "perfbench/reference").rglob("*.py")
    for path in reference:  # the reference imports nothing of the program either
        assert "repro_torch" not in _imports(path) and "perfbench" not in _imports(path), path


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole smoke run in a fresh process: every module it loaded, by
    top-level name compared whole (``repro_torch`` is not ``repro``)."""
    make_copy(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'perfbench/tests')!r}]\n"
        "from conftest import smoke_run\n"
        "from pathlib import Path\n"
        f"smoke_run(Path({str(tmp_path)!r}), 'tiny-moe.smoke')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300, cwd=tmp_path)
    assert done.returncode == 0, done.stderr
    loaded = set(json.loads(done.stdout.splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN


def test_run_py_refuses_without_a_card_or_a_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(ROOT / "perfbench", bare / "perfbench")
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "5", "--seconds", "1"],
                          cwd=bare, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""
