"""``launch.serve`` with ``--mesh-shape``: the reference's sharded serving
(``repro.launch.serve``'s ``tp_adapt``, ``DistContext``, expert axes) as a
world of gloo ranks on the CPU.

On mesh (1, 4) smoke mixtral (4 experts, tp_adapt's KV heads 2 -> 4 and
ep_shards 1) serves the same generations as one device does with the
tp-adapted config, in f32 at capacity factor 4 (E / top_k: no token can be
dropped), and every rank's logits (prefill's last position and every
decode step's) hold the one-device run's at 1e-4.  Each rank draws only
its expert and runs every MoE layer through two all-to-alls and one
all-gather, under trace spans; prefill takes the flash entry point once a
layer.  ``main --arch mixtral-8x22b --mesh-shape 1,8`` (4 experts x 2
shards) prints the serve lines once, from rank 0; the drills and a mesh
whose expert axis cannot serve the experts are refused before any world
starts.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.launch import serve
from repro_torch.sharding import tp_adapt

torch.set_num_threads(1)

MIXTRAL = "mixtral-8x22b"
B, P, N = 4, 16, 5


def test_serve_across_four_ranks_equals_one_device():
    cfg = dataclasses.replace(tcfgs.smoke_config(MIXTRAL), dtype="float32",
                              capacity_factor=4.0)
    adapted, ep_shards = tp_adapt(cfg, 4)
    assert ep_shards == 1 and adapted.n_kv_heads == 4
    one, ranks = [], []
    want = serve.run(adapted, batch=B, prompt_len=P, new_tokens=N, seed=0, device="cpu",
                     report=one)
    got = serve.run(cfg, batch=B, prompt_len=P, new_tokens=N, seed=0, device="cpu",
                    mesh_shape="1,4", report=ranks)
    np.testing.assert_array_equal(got, want)
    assert len(ranks) == 4
    layers = cfg.n_layers
    for r, rep in enumerate(ranks):
        assert rep["logits"].shape == (N + 1, B, cfg.vocab_size)
        np.testing.assert_allclose(rep["logits"], one[0]["logits"], rtol=1e-4, atol=1e-4)
        names = [(name, which) for name, which, _ in rep["spans"]]
        assert names.count(("moe.alltoall", "dispatch")) == layers * (N + 1), r
        assert names.count(("moe.alltoall", "combine")) == layers * (N + 1), r
        assert names.count(("moe.allgather", "")) == layers * (N + 1), r
        assert rep["launches"]["flash_attention"] == (0, layers), r
        assert len(rep["step_seconds"]) == N and rep["prefill_seconds"] > 0


def test_main_mixtral_across_eight_ranks_prints_once(capfd):
    gen = serve.main(["--arch", MIXTRAL, "--smoke", "--device", "cpu", "--mesh-shape", "1,8",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    out = capfd.readouterr().out.splitlines()
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert 0 <= gen.min() and gen.max() < tcfgs.smoke_config(MIXTRAL).vocab_size
    for head in ("[serve] prefill 2x8", "[serve] per-step plan:",
                 "[serve] decode ran eagerly on every step", "[serve] decoded 4 tokens x 2"):
        assert sum(ln.startswith(head) for ln in out) == 1, (head, out)
    assert any("mesh {'data': 1, 'model': 8}" in ln for ln in out)


@pytest.mark.parametrize("flags", [["--degrade-at", "1"], ["--fail-at", "2"],
                                   ["--scenario", "x.json"]])
def test_drills_are_refused_under_a_mesh(flags):
    with pytest.raises(ValueError, match="the drills run on one device"):
        serve.main(["--smoke", "--device", "cpu", "--mesh-shape", "1,2"] + flags)


def test_an_expert_axis_that_cannot_serve_the_experts_is_refused():
    """mixtral's 4 smoke experts on a model axis of 2: tp_adapt gives
    ep_shards 1, and one virtual expert a device needs 4."""
    with pytest.raises(ValueError, match="must hold E x ep_shards = 4 devices"):
        serve.main(["--arch", MIXTRAL, "--smoke", "--device", "cpu", "--mesh-shape", "4,2"])
