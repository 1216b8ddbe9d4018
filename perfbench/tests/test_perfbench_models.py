"""A model's own code found by name (``Spec.reference``): every configuration
reads, through its module, the leaves, weights, reference logits and counts
that it read before the module was named by the configuration; a
configuration whose module exists only as a new file runs end to end; an
unknown name fails with the path it looked for."""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest
import torch

from conftest import ROOT, TINY, make_copy, smoke_run, tiny_model
from perfbench import weights
from perfbench.reference import decoder, precision
from perfbench.spec import Spec
from perfbench.work import serve

CONFIGS = {p.stem: json.loads(p.read_text())["model"]
           for p in (ROOT / "perfbench/configs").glob("*.json")}
MODELS = dict(CONFIGS, **{name: tiny_model(name) for name in TINY})
SEED = 2**31 + 5

# Digests of what the benchmark read before the layout moved into the
# model's module (``weights.layout``, ``weights.draw`` and ``decoder.logits``
# as they were): the leaves of each model, the tiny models' weights at SEED,
# and their reference logits over ``_tokens`` in float32 and in the control's
# float8.
LAYOUT = {"mixtral-8x22b-d8": "2266b668a85d6477", "olmo-1b": "0391b71f06072e8a",
          "tiny-dense": "8e86f3a99ccea73a", "tiny-moe": "b439bb51cda02a52"}
DRAW = {("tiny-moe", "bfloat16"): "6759319f78a89e66", ("tiny-moe", "float32"): "1201b261554d5599",
        ("tiny-dense", "bfloat16"): "d25e43493191d2ce",
        ("tiny-dense", "float32"): "61753513e545262f"}
LOGITS = {("tiny-moe", "bfloat16"): ("e4ca6244168ad2be", "d2841602faff791c"),
          ("tiny-moe", "float32"): ("d2b06849e2c90377", "19a0d29bef7d2362"),
          ("tiny-dense", "bfloat16"): ("320a2ec3392bda95", "4aa7d0b6b68575f0"),
          ("tiny-dense", "float32"): ("43db2b812c2bcc41", "8f3659f6b418c8fa")}
# batch_flops (B=4, prompt 24, 6 new), decode_step_least_bytes (B=4, pos
# 30), flash_launch_flops and flash_launch_bytes (B=4, S=24), as before
COUNTS = {"mixtral-8x22b-d8": (1294560657408.0, 40472670208.0, 29491200.0, 2752512.0),
          "olmo-1b": (254293835776.0, 2370830336.0, 9830400.0, 1572864.0),
          "tiny-dense": (21469184.0, 294912.0, 307200.0, 49152.0),
          "tiny-moe": (31090688.0, 543872.0, 307200.0, 36864.0)}


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _leaves_digest(leaves) -> str:
    return _digest(repr([(p, s, str(d), std) for p, s, d, std in leaves]).encode())


def _tree_digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        if t is None:
            h.update(repr((path, None)).encode())
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            h.update(repr((path, tuple(t.shape), str(t.dtype))).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()[:16]


def _tokens(model: dict) -> torch.Tensor:
    gen = torch.Generator().manual_seed(7)
    return torch.randint(2, model["vocab_size"], (3, 20), generator=gen)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_models_module_gives_the_leaves_of_before(name):
    model = MODELS[name]
    reference = Spec(ROOT).reference(model)
    assert reference.__file__ == str(ROOT / "perfbench/reference/decoder.py")
    assert reference.work.__file__ == str(ROOT / "perfbench/work/serve.py")
    assert _leaves_digest(reference.layout(model)) == LAYOUT[name]


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_models_module_gives_the_weights_and_logits_of_before(name, dtype):
    model = tiny_model(name, dtype)
    reference = Spec(ROOT).reference(model)
    params = weights.draw(reference, model, SEED, "cpu")
    assert _tree_digest(params) == DRAW[name, dtype]
    precision.set_precision()
    with torch.no_grad():
        got = [reference.logits(model, params, _tokens(model), 15, linear)
               for linear in (precision.f32_linear, precision.fp8_linear)]
        direct = decoder.logits(model, params, _tokens(model), 15)
    assert tuple(_digest(t.numpy().tobytes()) for t in got) == LOGITS[name, dtype]
    assert torch.equal(got[0], direct)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_models_counts_are_those_of_before(name):
    model = MODELS[name]
    work = Spec(ROOT).reference(model).work
    got = (work.batch_flops(model, 4, 24, 6), work.decode_step_least_bytes(model, 4, 30),
           work.flash_launch_flops(model, 4, 24, 0), work.flash_launch_bytes(model, 4, 24))
    assert got == COUNTS[name]
    assert got[0] == serve.batch_flops(model, 4, 24, 6)


# A configuration's module that exists only in the copy: the decoder's code,
# each call written to a file beside it, and its own counts module.
RECORDED = '''"""The decoder, each call recorded."""
from pathlib import Path

from . import decoder

WORK = "recorded_counts"
CALLS = Path(__file__).with_name("recorded.calls")


def _note(name):
    with open(CALLS, "a") as f:
        f.write(name + "\\n")


def layout(model):
    _note("layout")
    return decoder.layout(model)


def absent(model):
    _note("absent")
    return decoder.absent(model)


def logits(model, params, tokens, first, linear):
    _note("logits")
    return decoder.logits(model, params, tokens, first, linear)
'''
RECORDED_COUNTS = '''"""serve.py's counts, each call of batch_flops recorded."""
from pathlib import Path

from perfbench.work.serve import batch_flops as _batch_flops

CALLS = Path(__file__).parents[1] / "reference" / "recorded.calls"


def batch_flops(model, batch, prompt_len, new_tokens):
    with open(CALLS, "a") as f:
        f.write("batch_flops\\n")
    return _batch_flops(model, batch, prompt_len, new_tokens)
'''
# a reader of the counts, so that a run off the card reads them too
BATCH_GFLOP = '''UNIT, RUN, SOURCE = "GFLOP", "traced", "program_counter"


def read(run):
    t = run.traffic
    return run.work.batch_flops(run.model, t["batch"], t["prompt_len"], t["new_tokens"]) / 1e9
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_recorded_cell(root: Path) -> str:
    """A configuration naming the module ``recorded``, and its cell, as new
    files and entries of the copy at ``root``."""
    pb = root / "perfbench"
    (pb / "reference/recorded.py").write_text(RECORDED)
    (pb / "work/recorded_counts.py").write_text(RECORDED_COUNTS)
    (pb / "metrics/serve.batch_gflop.py").write_text(BATCH_GFLOP)
    model = dict(tiny_model("tiny-moe", "float32"), reference="recorded")
    (pb / "configs/tiny-recorded.json").write_text(
        json.dumps({"name": "tiny-recorded", "model": model}))
    (pb / "checks/tiny-recorded.smoke.json").write_text(
        (pb / "checks/tiny-moe.smoke.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-recorded", "source": "smoke width",
                             "file": "perfbench/configs/tiny-recorded.json", "reduced": [],
                             "why": "smoke"})
    bench["workloads"].append({"name": "tiny-recorded.smoke", "config": "tiny-recorded",
                               "traffic": "smoke", "chips": 1, "why": "smoke"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny-recorded.smoke")
    bench["per_layer"].append({"name": "serve.batch_gflop", "unit": "GFLOP",
                               "better": "higher", "source": "program_counter",
                               "layer": "whole serving batch", "moves": "serve_tokens_per_s",
                               "workloads": ["tiny-recorded.smoke"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "tiny-recorded.smoke"


@pytest.mark.parametrize("trace", [False, True])
def test_a_module_that_exists_only_as_a_new_file_runs_end_to_end(tmp_path, trace):
    make_copy(tmp_path)
    before = _digests(tmp_path / "perfbench")
    cell = _add_recorded_cell(tmp_path)
    out = smoke_run(tmp_path, cell, trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    calls = (tmp_path / "perfbench/reference/recorded.calls").read_text().split()
    # the weights' layout and the None paths once, the reference once a
    # block of sampled requests, and in a traced run the counts' reader
    assert calls[:2] == ["layout", "absent"] and "logits" in calls
    assert ("batch_flops" in calls) == trace
    if trace:
        model = json.loads((tmp_path / "perfbench/configs/tiny-recorded.json").read_text())
        t = json.loads((tmp_path / "perfbench/traffic/smoke.json").read_text())
        want = serve.batch_flops(model["model"], t["batch"], t["prompt_len"], t["new_tokens"])
        assert out["metrics"]["serve.batch_gflop"]["value"] == pytest.approx(want / 1e9)
    after = _digests(tmp_path / "perfbench")  # no file of the copy changed
    assert all(after[path] == digest for path, digest in before.items())


def test_an_unknown_module_fails_with_the_path_it_looked_for(tmp_path):
    spec = Spec(ROOT)
    with pytest.raises(FileNotFoundError, match=re.escape(str(ROOT / "perfbench/reference/nowhere.py"))):
        spec.reference(dict(tiny_model("tiny-moe"), reference="nowhere"))
    make_copy(tmp_path)  # at set-up, before a weight is drawn
    path = tmp_path / "perfbench/configs/tiny-moe.json"
    conf = json.loads(path.read_text())
    conf["model"]["reference"] = "nowhere"
    path.write_text(json.dumps(conf))
    looked = re.escape(str(tmp_path / "perfbench/reference/nowhere.py"))
    with pytest.raises(FileNotFoundError, match=looked):
        smoke_run(tmp_path, "tiny-moe.smoke")
