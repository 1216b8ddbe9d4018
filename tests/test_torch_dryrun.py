"""The port's dry-run (``python -m repro_torch.launch.dryrun``), on the CPU.

Each fake world runs in a subprocess with a hard timeout (the world is global
to its process, and xdist shares workers); the subprocesses start together
in one module fixture.  Checked: the meta fields of every arch x shape x mesh
cell (and the serving layout of the MoE archs) against the reference's
``build_cell``; the cheapest cell end to end through the CLI, its record read
by ``benchmarks/roofline.py::terms``; a cell whose ``dot_flops`` is computed
by hand; the per-rank ``dot_flops`` of seven dense-decoder cells, of
llama-3.2-vision-11b's and rwkv6-1.6b's ``decode_32k``, of
recurrentgemma-9b's ``decode_32k`` and ``train_4k``, and of gemma2-9b's,
recurrentgemma-9b's and rwkv6-1.6b's ``long_500k`` against the
reference's own dry-run (both split the products over "model", and at
``long_500k``'s batch of 1 over "data" too: the FSDP blocks and the caches'
sequence chunks); the
collective tiers of a training cell on one pod and on two; the argument
bytes and ``dot_flops`` of llama3.2-1b's ``train_4k`` with the AdamW
moments on their own FSDP axes (``--opt-fsdp-axes pod+data`` on
``multi``, ``--no-fsdp`` on ``single``) against the reference's; and the
failure and ``--skip-existing`` handling.
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

# the cells whose per-rank dot_flops both packages count: (arch, shape,
# mesh); the dense decoders, llama-vision's cross-attention and rwkv6's
# time-mix and channel-mix (their train_4k cells trace for minutes)
FLOP_CELLS = [("llama3.2-1b", "train_4k", "single"), ("llama3.2-1b", "prefill_32k", "single"),
              ("llama3.2-1b", "decode_32k", "single"), ("olmo-1b", "prefill_32k", "single"),
              ("gemma2-9b", "train_4k", "single"), ("codeqwen1.5-7b", "decode_32k", "single"),
              ("llama3.2-1b", "train_4k", "multi"),
              ("llama-3.2-vision-11b", "decode_32k", "single"),
              ("rwkv6-1.6b", "decode_32k", "single")]
# recurrentgemma's RG-LRU block, in a subprocess of each package's own
# started with the others: the reference's train_4k traces for about 30 s
GRIFFIN_CELLS = [("recurrentgemma-9b", "decode_32k", "single"),
                 ("recurrentgemma-9b", "train_4k", "single")]
# the decode at batch 1 against a 524288-deep cache, split over "data" as
# the reference's GSPMD splits it, in a third pair of subprocesses
LONG_CELLS = [("gemma2-9b", "long_500k", "single"), ("recurrentgemma-9b", "long_500k", "single"),
              ("rwkv6-1.6b", "long_500k", "single")]
# the AdamW moments on their own FSDP axes, in a fourth pair: ZeRO-1 over
# "pod" (the moments over "pod" x "data") and --no-fsdp (whole parameters,
# the moments over "data"); (arch, shape, mesh, tag, flags)
ZERO1_CELLS = [("llama3.2-1b", "train_4k", "multi", "zero1", ["--opt-fsdp-axes", "pod+data"]),
               ("llama3.2-1b", "train_4k", "single", "nofsdp", ["--no-fsdp"])]

# one package's dry-run of FLOP_CELLS (or of ZERO1_CELLS, with their tags
# and flags), its CLI in one process; {pkg} is repro or repro_torch (the
# reference's main reads sys.argv)
_FLOP_CELLS = """
import json, sys
from {pkg}.launch import dryrun
out, cells = sys.argv[1], json.loads(sys.argv[2])
for arch, shape, mesh, *variant in cells:
    tag, flags = variant or ("baseline", [])
    sys.argv = ["dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out,
                "--tag", tag, *flags]
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
        "ref_flops_griffin": _start(["-c", _FLOP_CELLS.format(pkg="repro"), str(tmp / "ref"),
                                     json.dumps(GRIFFIN_CELLS)]),
        "port_flops_griffin": _start(["-c", _FLOP_CELLS.format(pkg="repro_torch"),
                                      str(tmp / "port"), json.dumps(GRIFFIN_CELLS)]),
        "ref_flops_long": _start(["-c", _FLOP_CELLS.format(pkg="repro"), str(tmp / "ref"),
                                  json.dumps(LONG_CELLS)]),
        "port_flops_long": _start(["-c", _FLOP_CELLS.format(pkg="repro_torch"),
                                   str(tmp / "port"), json.dumps(LONG_CELLS)]),
        "ref_zero1": _start(["-c", _FLOP_CELLS.format(pkg="repro"), str(tmp / "ref"),
                             json.dumps(ZERO1_CELLS)]),
        "port_zero1": _start(["-c", _FLOP_CELLS.format(pkg="repro_torch"), str(tmp / "port"),
                              json.dumps(ZERO1_CELLS)]),
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


@pytest.mark.parametrize("cell", FLOP_CELLS + GRIFFIN_CELLS + LONG_CELLS,
                         ids=["/".join(c) for c in FLOP_CELLS + GRIFFIN_CELLS + LONG_CELLS])
def test_dot_flops_equal_the_reference_s(runs, cell):
    """Each rank's dot FLOPs of a cell are the reference's (its GSPMD splits
    the products over "model", cross-attention's, RWKV's and the RG-LRU's
    included, and where the batch does not split over "data", a
    ``long_500k`` decode's, over "data" too; the port splits them alike):
    within 1%."""
    tmp, done = runs
    which = ("_griffin" if cell in GRIFFIN_CELLS else "_long" if cell in LONG_CELLS
             else "")
    _ok(done["ref_flops" + which])
    _ok(done["port_flops" + which])
    name = "__".join(cell) + "__baseline.json"
    ref, port = _record(tmp / "ref" / name), _record(tmp / "port" / name)
    assert ref["ok"] is True and port["ok"] is True
    assert port["hlo_cost"]["dot_flops"] == pytest.approx(ref["hlo_cost"]["dot_flops"],
                                                          rel=1e-2)


def test_long_decode_moves_no_weights_or_caches(runs):
    """gemma2-9b long_500k single, batch 1: decode computes on the weights'
    FSDP blocks and the KV caches' sequence chunks over "data", so each
    rank's collectives move activations and softmax parts only, under 0.2
    GB (gathering the blocks and chunks whole moved 12.86 GB a step), and
    its all-gathers under 1 MB each on average (an activation's channels)."""
    tmp, done = runs
    _ok(done["port_flops_long"])
    rec = _record(tmp / "port" / "gemma2-9b__long_500k__single__baseline.json")
    hc = rec["hlo_cost"]
    assert rec["ok"] is True and rec["tokens_global"] == 1
    assert 0 < hc["collective_ici_bytes"] < 2e8 and hc["collective_dcn_bytes"] == 0
    gathers = hc["collectives"]["all-gather"]
    assert gathers["ici_bytes"] / gathers["count"] < 1e6


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


@pytest.mark.parametrize("cell", ZERO1_CELLS, ids=[c[3] for c in ZERO1_CELLS])
def test_moments_on_their_own_axes_hold_the_reference_s_bytes_and_flops(runs, cell):
    """llama3.2-1b train_4k with the AdamW moments on their own FSDP axes
    (ZeRO-1 over "pod" on ``multi``, ``--no-fsdp`` on ``single``): the
    rank's arguments take the reference's bytes exactly (parameters by
    their rules, moments by the FSDP rules on their axes) and its dot
    FLOPs are the reference's."""
    tmp, done = runs
    _ok(done["ref_zero1"])
    _ok(done["port_zero1"])
    name = "__".join(cell[:4]) + ".json"
    ref, port = _record(tmp / "ref" / name), _record(tmp / "port" / name)
    assert ref["ok"] is True and port["ok"] is True
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    assert port["hlo_cost"]["dot_flops"] == ref["hlo_cost"]["dot_flops"]


def test_zero1_gathers_the_parameters_back_across_pods(runs):
    """Under ZeRO-1 each rank holds and updates its block of the moments
    split over "pod" x "data", then all-gathers the updated values over
    that group, across the pods: its argument bytes fall below the default
    cell's and its DCN bytes, the all-gathers' among them, exceed them."""
    tmp, done = runs
    _ok(done["port_flops"])
    _ok(done["port_zero1"])
    zero1 = _record(tmp / "port" / "llama3.2-1b__train_4k__multi__zero1.json")
    base = _record(tmp / "port" / "llama3.2-1b__train_4k__multi__baseline.json")
    assert zero1["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    assert (zero1["hlo_cost"]["collectives"]["all-gather"]["dcn_bytes"]
            > base["hlo_cost"]["collectives"].get("all-gather", {}).get("dcn_bytes", 0))
    assert zero1["hlo_cost"]["collective_dcn_bytes"] > base["hlo_cost"]["collective_dcn_bytes"]


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
