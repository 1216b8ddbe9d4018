"""The port's dry-run (``python -m repro_torch.launch.dryrun``), on the CPU.

Each fake world runs in a subprocess with a hard timeout (the world is global
to its process, and xdist shares workers); the subprocesses start together
in one module fixture.  Checked: the meta fields of every arch x shape x mesh
cell (and the serving layout of the MoE archs) against the reference's
``build_cell``; the cheapest cell end to end through the CLI, its record read
by ``benchmarks/roofline.py::terms``; a cell whose ``dot_flops`` is computed
by hand; the per-rank ``dot_flops`` of seven dense-decoder cells against
the reference's own dry-run (both split the products over "model"); the
collective tiers of a training cell on one pod and on two; and the failure
and ``--skip-existing`` handling.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.configs as tcfgs
from repro_torch.sharding.specs import tp_adapt

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT = 240

ARCHS = list(tcfgs.ARCHS)
SHAPES = list(tcfgs.SHAPES)
SERVE_MOE = ["mixtral-8x22b", "dbrx-132b"]
META_KEYS = ("deploy_kv_heads", "ep_shards", "ep_axes", "moe_strategy_resolved", "params",
             "active_params", "tokens_global", "step_kind", "skipped")

# every cell's build_cell meta, as JSON on the last line; {pkg} is repro or
# repro_torch (the reference's module sets XLA_FLAGS when imported)
_META = """
import json, sys
from {pkg}.launch import dryrun
archs, shapes, serve = json.loads(sys.argv[1])
out = {{}}
for mk in ("single", "multi"):
    cells = [(a, s, {{}}) for a in archs for s in shapes]
    cells += [(a, s, {{"serve_layout": True, "moe_strategy": "auto"}}) for a in serve
              for s in shapes]
    for a, s, v in cells:
        meta = dryrun.build_cell(a, s, mk, v)[2]
        out["|".join((a, s, mk, "serve" if v else "base"))] = meta
print(json.dumps(out))
"""

# the dense-decoder cells whose per-rank dot_flops both packages count:
# (arch, shape, mesh)
FLOP_CELLS = [("llama3.2-1b", "train_4k", "single"), ("llama3.2-1b", "prefill_32k", "single"),
              ("llama3.2-1b", "decode_32k", "single"), ("olmo-1b", "prefill_32k", "single"),
              ("gemma2-9b", "train_4k", "single"), ("codeqwen1.5-7b", "decode_32k", "single"),
              ("llama3.2-1b", "train_4k", "multi")]

# one package's dry-run of FLOP_CELLS, its CLI in one process; {pkg} is
# repro or repro_torch (the reference's main reads sys.argv)
_FLOP_CELLS = """
import json, sys
from {pkg}.launch import dryrun
out, cells = sys.argv[1], json.loads(sys.argv[2])
for arch, shape, mesh in cells:
    sys.argv = ["dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out]
    dryrun.main()
"""

# the other cells whose records the tests read, and the failure handling
_CELLS = """
import json, os, sys
from repro_torch.launch import dryrun
out = sys.argv[1]
fail = os.path.join(out, "fail")
try:
    dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--out", fail])
    code = 0
except SystemExit as e:
    code = e.code
cache = os.path.join(out, "cache")
os.makedirs(cache)
with open(os.path.join(cache, "llama3.2-1b__long_500k__single__baseline.json"), "w") as f:
    json.dump({"ok": True, "marker": "kept"}, f)
with open(os.path.join(cache, "llama3.2-1b__long_500k__multi__baseline.json"), "w") as f:
    f.write('{"ok": tr')  # truncated
dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k", "--mesh", "both",
             "--skip-existing", "--out", cache])
print(json.dumps({"fail_code": code}))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)  # the reference's dryrun sets its own
    return env


def _start(args):
    return subprocess.Popen([sys.executable, *args], env=_env(), cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the file, started together."""
    cells = [ARCHS, SHAPES, SERVE_MOE]
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {
        "ref_meta": _start(["-c", _META.format(pkg="repro"), json.dumps(cells)]),
        "port_meta": _start(["-c", _META.format(pkg="repro_torch"), json.dumps(cells)]),
        "cli": _start(["-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-1.6b", "--shape",
                       "long_500k", "--mesh", "multi", "--out", str(tmp / "cli")]),
        "cells": _start(["-c", _CELLS, str(tmp / "cells")]),
        "ref_flops": _start(["-c", _FLOP_CELLS.format(pkg="repro"), str(tmp / "ref"),
                             json.dumps(FLOP_CELLS)]),
        "port_flops": _start(["-c", _FLOP_CELLS.format(pkg="repro_torch"), str(tmp / "port"),
                              json.dumps(FLOP_CELLS)]),
    }
    try:
        done = {name: _finish(p) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return tmp, done


def _ok(run):
    code, out, err = run
    assert code == 0, err[-3000:]
    return out


def _record(path):
    with open(path) as f:
        return json.load(f)


def test_meta_fields_equal_the_reference_s(runs):
    """deploy_kv_heads, ep_shards, ep_axes, the resolved MoE strategy, the
    parameter counts, tokens and step kind, and the long_500k skips: equal
    on all 80 cells and the MoE archs' serving layout."""
    _, done = runs
    ref = json.loads(_ok(done["ref_meta"]).strip().splitlines()[-1])
    port = json.loads(_ok(done["port_meta"]).strip().splitlines()[-1])
    assert len(ref) == 2 * (len(ARCHS) + len(SERVE_MOE)) * len(SHAPES) == len(port)
    diffs = {cell: (k, ref[cell].get(k), port[cell].get(k))
             for cell in ref for k in META_KEYS if ref[cell].get(k) != port[cell].get(k)}
    assert not diffs, diffs
    skipped = sorted(c for c, m in port.items() if "skipped" in m and c.endswith("|base"))
    full_attention = [a for a in ARCHS if not tcfgs.get_config(a).sub_quadratic]
    assert skipped == sorted(f"{a}|long_500k|{mk}|base" for a in full_attention
                             for mk in ("single", "multi"))
    assert port["mixtral-8x22b|decode_32k|multi|serve"]["ep_axes"] == ["data", "model"]


def test_cheapest_cell_end_to_end(runs):
    """The CLI on rwkv6-1.6b long_500k multi: an ok record with dot FLOPs,
    every key ``benchmarks/roofline.py::terms`` reads, and those terms."""
    tmp, done = runs
    _ok(done["cli"])
    rec = _record(tmp / "cli" / "rwkv6-1.6b__long_500k__multi__baseline.json")
    assert rec["ok"] is True and rec["hlo_cost"]["dot_flops"] > 0
    assert rec["step_kind"] == "decode" and rec["tokens_global"] == 1
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "generated_code_bytes"}
    assert rec["cost"]["bytes_accessed"] == rec["hlo_cost"]["hbm_bytes"] > 0
    assert rec["trace_s"] >= 0 and "compile_s" not in rec and "hlo_chars" not in rec
    spec = importlib.util.spec_from_file_location("roofline", ROOT / "benchmarks" / "roofline.py")
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    terms = roofline.terms(rec)
    assert terms["compute_s"] > 0 and terms["memory_s"] > 0 and terms["collective_s"] > 0
    assert terms["model_flops"] == 2 * rec["active_params"]


def test_decode_cell_dot_flops_by_hand(runs):
    """llama3.2-1b decode_32k single: this rank's 128/16 tokens through every
    layer's products on its blocks over "model" (its 32/16 query heads and
    16/16 KV heads, its 8192/16 FF columns), its 1/16 of the tied
    unembedding, and its heads' attention over the 32768-deep cache (QK^T
    and PV): 3.41678e9, the reference's."""
    tmp, done = runs
    _ok(done["port_flops"])
    rec = _record(tmp / "port" / "llama3.2-1b__decode_32k__single__baseline.json")
    cfg, _ = tp_adapt(tcfgs.get_config("llama3.2-1b"), 16)
    tp = 16
    d, dh, ff = cfg.d_model, cfg.head_dim_, cfg.d_ff // tp
    H, G = cfg.n_heads // tp, cfg.n_kv_heads // tp
    T, S = 128 // 16, 32768
    assert cfg.tie_embeddings and cfg.gated and G == 1
    weights = d * H * dh + 2 * d * G * dh + H * dh * d + 3 * d * ff
    want = (cfg.n_layers * (2 * T * weights + 4 * T * S * H * dh)
            + 2 * T * d * cfg.vocab_padded // tp)
    assert want == pytest.approx(3.41678e9, rel=1e-5)
    assert rec["hlo_cost"]["dot_flops"] == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("cell", FLOP_CELLS, ids=["/".join(c) for c in FLOP_CELLS])
def test_dot_flops_equal_the_reference_s(runs, cell):
    """Each rank's dot FLOPs of a dense-decoder cell are the reference's
    (its GSPMD splits the products over "model"; the port splits them
    alike): within 1%."""
    tmp, done = runs
    _ok(done["ref_flops"])
    _ok(done["port_flops"])
    name = "__".join(cell) + "__baseline.json"
    ref, port = _record(tmp / "ref" / name), _record(tmp / "port" / name)
    assert ref["ok"] is True and port["ok"] is True
    assert port["hlo_cost"]["dot_flops"] == pytest.approx(ref["hlo_cost"]["dot_flops"],
                                                          rel=1e-2)


def test_train_collectives_cross_pods_only_on_two(runs):
    """llama3.2-1b train_4k: no DCN bytes on one pod; on two the data-parallel
    gradient reduce spans the pods."""
    tmp, done = runs
    _ok(done["port_flops"])
    single = _record(tmp / "port" / "llama3.2-1b__train_4k__single__baseline.json")
    multi = _record(tmp / "port" / "llama3.2-1b__train_4k__multi__baseline.json")
    assert single["ok"] is True and multi["ok"] is True
    assert single["hlo_cost"]["collective_dcn_bytes"] == 0
    assert single["hlo_cost"]["collective_ici_bytes"] > 0
    assert multi["hlo_cost"]["collectives"]["all-reduce"]["dcn_bytes"] > 0
    assert multi["memory"]["alias_bytes"] > 0  # weights and moments updated in place


def test_failure_and_skip_existing(runs):
    """A failing cell writes ok: false with its error and the run exits 1;
    --skip-existing keeps an ok record and re-runs a truncated one."""
    tmp, done = runs
    _, out, err = done["cells"]
    assert json.loads(out.strip().splitlines()[-1])["fail_code"] == 1
    bad = _record(tmp / "cells" / "fail" / "no-such-arch__decode_32k__single__baseline.json")
    assert bad["ok"] is False and bad["error"].startswith("KeyError")
    assert "no-such-arch__decode_32k__single__baseline: failed with KeyError" in err
    cache = tmp / "cells" / "cache"
    assert _record(cache / "llama3.2-1b__long_500k__single__baseline.json")["marker"] == "kept"
    assert "llama3.2-1b__long_500k__single__baseline: cached ok=True" in out
    assert "llama3.2-1b__long_500k__multi__baseline: ignoring unreadable cache record" in err
    rerun = _record(cache / "llama3.2-1b__long_500k__multi__baseline.json")
    assert rerun["ok"] == "skipped"
