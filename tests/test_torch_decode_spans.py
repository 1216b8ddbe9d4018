"""The port's spans inside prefill and the decode step (``models/decode.py``),
on the CPU at smoke width, under ``torch.profiler`` with CPU activity.

Each call of ``prefill`` is one ``model.prefill`` range holding, for each
layer, its mixer's span (``model.attention``, or ``model.time_mix`` for
RWKV) and ``model.ffn`` (mixtral's MoE, the MLP, RWKV's channel-mix), and
one ``model.head``; each eager decode step of a ``DecodeGraph`` is one
``model.decode_step`` holding the same.  The ranges change nothing that is
computed: the logits are equal bit for bit with the profiler on and off.
No span name is one of the benchmark's host phases or of ``serve.run``'s
spans, so none of them nests inside a range of its own name.
"""
import collections
import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import decode as dec
from repro_torch.models.transformer import init_params

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = ("model.", "graph.")
MIXER = {"llama3.2-1b": "model.attention", "mixtral-8x22b": "model.attention",
         "rwkv6-1.6b": "model.time_mix"}
B, P, N = 2, 12, 3


def _serve(arch):
    """Prefill, then N eager steps of a ``DecodeGraph``: every logits tensor."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (B, P)))
    logits, caches = dec.prefill(cfg, params, tokens, capacity=P + N)
    steps = dec.DecodeGraph(cfg, params, caches, logits.argmax(-1)[:, None], P, N)
    return cfg, [logits] + [steps.step().clone() for _ in range(N)]


def _paths(prof) -> collections.Counter:
    """Each program range by its path of program ranges around it."""
    paths = collections.Counter()
    for e in prof.events():
        if not e.name.startswith(PREFIXES):
            continue
        names, parent = [e.name], e.cpu_parent
        while parent is not None:
            if parent.name.startswith(PREFIXES):
                names.append(parent.name)
            parent = parent.cpu_parent
        paths["/".join(reversed(names))] += 1
    return paths


@pytest.mark.parametrize("arch", list(MIXER))
def test_spans_nest_once_per_layer_and_change_nothing(arch):
    torch.manual_seed(0)
    cfg, plain = _serve(arch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, traced = _serve(arch)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    L, mixer = cfg.n_layers, MIXER[arch]
    want = {"model.prefill": 1, f"model.prefill/{mixer}": L, "model.prefill/model.ffn": L,
            "model.prefill/model.head": 1, "model.decode_step": N,
            f"model.decode_step/{mixer}": N * L, "model.decode_step/model.ffn": N * L,
            "model.decode_step/model.head": N}
    assert dict(_paths(prof)) == want


def test_span_names_are_no_phase_or_serve_span():
    """The names in ``models/decode.py`` against the benchmark's host phases
    (``perfbench/serving.py``) and the spans ``launch/serve.py`` opens."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.serving import PHASES

    opened = re.compile(r"""trace\.span\(\s*["']([^"']+)["']""")
    ours = set(opened.findall((ROOT / "src/repro_torch/models/decode.py").read_text()))
    serves = set(opened.findall((ROOT / "src/repro_torch/launch/serve.py").read_text()))
    assert {"model.prefill", "model.decode_step", "model.attention", "model.ffn",
            "model.head", "graph.warmup", "graph.warmup.wait", "graph.capture",
            "graph.capture.record"} <= ours
    assert all(name.startswith(PREFIXES) for name in ours)
    assert {"prefill", "decode", "decode.step"} <= serves
    assert not ours & (set(PHASES) | serves)
