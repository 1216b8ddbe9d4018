"""The work counts (``perfbench/work``), the weights' layout and the
configuration files, on the CPU."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT
from perfbench import weights
from perfbench.reference import decoder
from perfbench.work import serve as work

CONFIGS = {p.stem: json.loads(p.read_text()) for p in (ROOT / "perfbench/configs").glob("*.json")}
MIXTRAL = CONFIGS["mixtral-8x22b-d8"]["model"]
OLMO = CONFIGS["olmo-1b"]["model"]


def test_mixtral_long_prompt_batch_flops():
    # B=8, prompt 2048, 16 new: 2 x 5.54 G active matrix weights x 16,512
    # tokens, plus causal attention over 2048 and the head where it is taken
    assert work.batch_flops(MIXTRAL, 8, 2048, 16) == pytest.approx(1.85e14, rel=0.01)


def test_olmo_chat_prefill_flops_and_step_bytes():
    assert work.prefill_flops(OLMO, 64, 1024) == pytest.approx(1.45e14, rel=0.01)
    # weights 2.35 GB + K and V of about 1152 filled positions, 64 x 16 layers
    assert work.decode_step_least_bytes(OLMO, 64, 1024 + 128) == pytest.approx(12.0e9, rel=0.01)
    assert work.decode_weight_bytes(OLMO, 64) == pytest.approx(2.35e9, rel=0.01)


def test_moe_is_counted_at_top_k():
    more_experts = dict(MIXTRAL, n_experts=64)
    # only the router grows with the expert count
    router = 2 * MIXTRAL["d_model"] * (64 - 8) * 8
    assert work.token_matrix_params(more_experts) * 2 - work.token_matrix_params(MIXTRAL) * 2 \
        == router
    top4 = dict(MIXTRAL, top_k=4)
    expert = 3 * MIXTRAL["d_model"] * MIXTRAL["d_ff"]
    assert work.token_matrix_params(top4) - work.token_matrix_params(MIXTRAL) == 2 * expert * 8


def test_attention_counts_attended_positions():
    assert work.attended_pairs(4) == 10
    assert work.attended_pairs(6, window=2) == 3 + 4 * 2
    assert work.attended_pairs(6, window=8) == 21
    step = work.decode_step_flops(OLMO, 1, 99) - work.decode_step_flops(OLMO, 1, 98)
    assert step == 4 * 128 * 16 * 16  # one more key for 16 heads in 16 layers


def test_flash_launch_counts():
    flops = work.flash_launch_flops(MIXTRAL, 8, 2048, 4096)
    assert flops == 4 * 128 * 48 * 8 * (2048 * 2049 // 2)
    assert work.flash_launch_bytes(OLMO, 64, 1024) == 2 * 64 * 1024 * 128 * (2 * 16 + 2 * 16)
    from perfbench.work.peaks import peaks

    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert work.least_seconds(989e12, 0.0, h100) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        peaks("cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_layout_is_the_ports(name):
    """The benchmark's own layout, through the configuration's module (its
    leaves and the paths it holds as None), against the port's init on the
    meta device."""
    from perfbench.harness import port_config
    from perfbench.spec import Spec
    from repro_torch.models.transformer import param_shapes

    model = CONFIGS[name]["model"]
    reference = Spec(ROOT).reference(model)
    cfg = port_config(model)
    want = {}

    def walk(tree, path):
        if tree is None:
            want[path] = None
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            want[path] = (tuple(tree.shape), tree.dtype)

    walk(param_shapes(cfg), ())
    got = {path: (shape, dt) for path, shape, dt, _ in reference.layout(model)}
    got.update((path, None) for path in reference.absent(model))
    assert got == want
    assert work.vocab_rows(model) == cfg.vocab_padded == decoder.vocab_rows(model)
    table = 0 if cfg.tie_embeddings else work.head_params(model)  # the untied input table
    assert work.token_matrix_params(model) + work.head_params(model) + table \
        == cfg.active_param_count()


def test_weights_bytes_and_draw():
    assert weights.nbytes(decoder.layout(MIXTRAL)) == pytest.approx(40.87e9, rel=0.001)
    assert weights.nbytes(decoder.layout(OLMO)) == pytest.approx(2.35e9, rel=0.01)
    from conftest import tiny_model

    model = tiny_model("tiny-moe")
    a, b = (weights.draw(decoder, model, 2**31 + 5, "cpu") for _ in range(2))
    assert torch.equal(a["groups"][0][0]["moe"]["w_in"], b["groups"][0][0]["moe"]["w_in"])
    c = weights.draw(decoder, model, 2**31 + 6, "cpu")
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    w = a["groups"][0][0]["attn"]["wq"].float()
    assert w.std().item() == pytest.approx(64 ** -0.5, rel=0.1)
    assert torch.all(a["groups"][0][0]["ln1"]["scale"] == 1)
    assert a["groups"][0][0]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_file_states_its_cut(name):
    conf = CONFIGS[name]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == name)
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])
    assert entry["file"] == f"perfbench/configs/{name}.json"
    m = conf["model"]
    if name == "mixtral-8x22b-d8":  # the published keys against the model as run
        assert (conf["hidden_size"], conf["intermediate_size"], conf["num_attention_heads"],
                conf["num_key_value_heads"], conf["num_local_experts"],
                conf["num_experts_per_tok"], conf["vocab_size"], conf["rope_theta"]) == \
            (m["d_model"], m["d_ff"], m["n_heads"], m["n_kv_heads"], m["n_experts"],
             m["top_k"], m["vocab_size"], m["rope_theta"])
        assert conf["num_hidden_layers"] == sum(g["count"] for g in m["groups"])
    else:
        assert (conf["d_model"], conf["n_heads"], conf["n_layers"], conf["weight_tying"]) == \
            (m["d_model"], m["n_heads"], sum(g["count"] for g in m["groups"]),
             m["tie_embeddings"])
        assert conf["mlp_ratio"] * conf["d_model"] == 2 * m["d_ff"]
        assert conf["embedding_size"] == work.vocab_rows(m)
