"""Shared pieces of the benchmark's tests: smoke-width models and a copy of
the benchmark with a smoke cell of each, which the CPU drives end to end
(``harness.run_cell`` on ``device="cpu"``: everything but the look for a
card)."""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-moe": {"name": "tiny-moe", "family": "moe", "d_model": 64, "n_heads": 4,
                 "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
                 "groups": [{"pattern": ["local"], "count": 2}], "head_dim": 16,
                 "n_experts": 4, "top_k": 2, "window": 4096, "rope_theta": 1e6,
                 "norm": "rmsnorm", "act": "silu", "gated": True, "tie_embeddings": False,
                 "dtype": "bfloat16"},
    "tiny-dense": {"name": "tiny-dense", "family": "dense", "d_model": 64, "n_heads": 4,
                   "n_kv_heads": 4, "d_ff": 128, "vocab_size": 300,
                   "groups": [{"pattern": ["attn"], "count": 2}], "head_dim": 16,
                   "rope_theta": 1e4, "norm": "nonparam_ln", "act": "silu", "gated": True,
                   "tie_embeddings": True, "dtype": "bfloat16"},
}
TINY_TRAFFIC = {"loop": "closed_batches", "batch": 4, "prompt_len": 24, "new_tokens": 6,
                "decoding": "greedy", "prompt_ids": "uniform", "check_requests": 6}
# The smoke cells run in float32, as the reference does, so that a sound
# run's gaps are rounding alone: both tiny models read a widest gap of 0 on
# seeds 1-12, and every planted fault reads a widest gap of 0.69 or more
# and a mean gap of 0.062 or more.
TINY_CHECKS = {"mean_logit_gap": {"limit": 1e-3}, "max_logit_gap": {"limit": 1e-2}}


def tiny_model(name: str, dtype: str = "bfloat16") -> dict:
    return dict(copy.deepcopy(TINY[name]), dtype=dtype)


def make_copy(dest: Path, dtype: str = "float32", checks: dict = TINY_CHECKS) -> Path:
    """A copy of BENCHMARK.json and perfbench/ at ``dest`` with a smoke cell
    ``<tiny>.smoke`` of each tiny model in ``dtype``, added as new files and
    entries, its limits ``checks``."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "perfbench/traffic/smoke.json").write_text(json.dumps(TINY_TRAFFIC))
    for name in TINY:
        (dest / f"perfbench/configs/{name}.json").write_text(
            json.dumps({"name": name, "model": tiny_model(name, dtype)}))
        cell = f"{name}.smoke"
        (dest / f"perfbench/checks/{cell}.json").write_text(json.dumps(checks))
        bench["configs"].append({"name": name, "source": "smoke width",
                                 "file": f"perfbench/configs/{name}.json", "reduced": [],
                                 "why": "smoke"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": "smoke",
                                   "chips": 1, "why": "smoke"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def bench_copy(tmp_path):
    return make_copy(tmp_path)


def smoke_run(root: Path, cell: str, seed: int = 2**31 + 11, trace: bool = False,
              seconds: float = 0.5) -> dict:
    """One run of a smoke cell on the CPU, as ``run.py`` runs it on the card."""
    import time

    from perfbench import harness
    from perfbench.spec import Spec

    spec = Spec(root, root / "perfbench")
    return harness.run_cell(spec, spec.cell(cell), seed, seconds, trace, "cpu",
                            time.perf_counter())[1]
