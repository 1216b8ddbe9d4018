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
shards) prints the serve lines once, from rank 0; a mesh whose expert axis
cannot serve the experts is refused before any world starts.  The drills
run on every rank of a world: a shed on (2, 1), the degradation drill and a
host shrunk on (2, 2) against the reference's serve on 4 virtual devices,
and a seeded scenario on mixtral (1, 4).
"""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from _torch_obs_parity import _fresh_planners, fresh_both, t_obs  # noqa: F401  (autouse)
from repro_torch.launch import serve
from repro_torch.sharding import tp_adapt

torch.set_num_threads(1)

MIXTRAL = "mixtral-8x22b"
B, P, N = 4, 16, 5
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
DRILL_LINE = re.compile(r"^\[serve\] (link|host|scenario|per-step plan)")
DRILL_SERVE = ("serve.decode.tokens", "serve.batch.live", "serve.simulated_makespan_s")


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
    # the reference's summary under any mesh: six prefixes, the final simulation's gauge
    (summary,) = [ln for ln in out if ln.startswith("[serve] metrics:")]
    assert "serve.simulated_makespan_s=" in summary and "engine.runs=1" in summary


def _drill_values(snap: dict) -> dict:
    """The drills' counters and gauges: the families that depend on the
    drills and not on the plan shape."""
    return {k: v for kind in ("counters", "gauges") for k, v in snap[kind].items()
            if k.startswith(("runtime.", "health.")) or k in DRILL_SERVE}


def _one_device(cfg, capsys, **kw):
    fresh_both()
    gen = serve.run(cfg, batch=B, prompt_len=8, new_tokens=12, seed=0, device="cpu", **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if DRILL_LINE.match(ln)]
    return gen, lines, _drill_values(t_obs.metrics.to_json())


def _world(cfg, mesh_shape, **kw):
    ranks = []
    gen = serve.run(cfg, batch=B, prompt_len=8, new_tokens=12, seed=0, device="cpu",
                    mesh_shape=mesh_shape, report=ranks, **kw)
    return gen, ranks


def test_shed_on_a_mesh_equals_one_device(capsys):
    """Degradation at step 3 and a shed at step 6 on (2, 1), f32: the
    generations of one device's shed run (the shed row -1 from step 7), its
    drill lines and its drill counters and gauges, on every rank alike; the
    shed gathers the caches over "data", cuts them to 3 rows and replicates
    them (2 does not divide 3)."""
    cfg = dataclasses.replace(tcfgs.smoke_config("llama3.2-1b"), dtype="float32")
    drill = dict(degrade_at=3, fail_at=6, fail_mode="shed")
    one = []
    want, lines, values = _one_device(cfg, capsys, report=one, **drill)
    got, ranks = _world(cfg, "2,1", **drill)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(one[0]["logits"][7:, B - 1]).all() and not np.isnan(one[0]["logits"][:7]).any()
    assert (got[B - 1, 7:] == -1).all() and (got[B - 1, :7] >= 0).all() and (got[:B - 1] >= 0).all()
    assert lines[1] == "[serve] host 0 lost at decode step 6; shed one sequence (batch 4 -> 3)"
    counters = ranks[0]["metrics"]["counters"]
    for r, rep in enumerate(ranks):
        assert [ln for ln in rep["lines"] if DRILL_LINE.match(ln)] == lines, r
        assert _drill_values(rep["metrics"]) == values, r
        assert rep["metrics"]["counters"] == counters, r
        assert np.isnan(rep["logits"][7:, B - 1]).all() and np.isfinite(rep["logits"][:7]).all()
        np.testing.assert_allclose(rep["logits"], one[0]["logits"], rtol=1e-4, atol=1e-4)
    assert values["serve.decode.tokens"] == 4 * 6 + 3 * 6 and values["serve.batch.live"] == 3


def _summary(lines) -> dict:
    """The summary line's counters and gauges (its histograms are times)."""
    (line,) = [ln for ln in lines if ln.startswith("[serve] metrics:")]
    items = line.split(": ", 1)[1].split()
    return dict(item.split("=", 1) for item in items if "@" not in item)


def test_degrade_and_shrink_on_a_2x2_mesh_match_the_reference(capfd):
    """The reference's ``repro.launch.serve`` on 4 virtual devices against
    the port's world of 4 on (2, 2), smoke llama, the degradation drill at
    step 3 and a host shrunk at step 6: the same drill lines and per-step
    plan, and the same counters and gauges in the six-prefix summary line
    (the simulated makespan included)."""
    argv = ["--smoke", "--batch", "4", "--prompt-len", "8", "--new-tokens", "12",
            "--degrade-at", "3", "--fail-at", "6", "--fail-mode", "shrink", "--mesh-shape", "2,2"]
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC}
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve"] + argv, env=env,
                         capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = ref.stdout.splitlines()
    capfd.readouterr()
    serve.main(argv + ["--device", "cpu"])
    got = capfd.readouterr().out.splitlines()
    pick = lambda out: [ln for ln in out if DRILL_LINE.match(ln)]  # noqa: E731
    assert pick(got) == pick(want) and len(pick(want)) == 3
    assert _summary(got) == _summary(want)
    assert "serve.simulated_makespan_s" in _summary(got)
    assert "runtime.elastic.reshapes" in _summary(got)


def test_a_scenario_on_mixtral_across_four_ranks(tmp_path, capsys):
    """A seeded scenario (seed 3: a host lost at step 2, link sags) on
    mixtral (1, 4), f32, shed mode: the experts' capacity follows the live
    batch; the generations, drill lines and drill values of one device's
    run of the tp-adapted config."""
    from repro_torch.runtime.scenarios import generate

    path = tmp_path / "scenario.json"
    generate(3, 12, hosts=4, n_events=4, tiers=("dcn",)).save(str(path))
    cfg = dataclasses.replace(tcfgs.smoke_config(MIXTRAL), dtype="float32", capacity_factor=4.0)
    drill = dict(scenario=str(path), fail_mode="shed")
    want, lines, values = _one_device(tp_adapt(cfg, 4)[0], capsys, **drill)
    got, ranks = _world(cfg, "1,4", **drill)
    np.testing.assert_array_equal(got, want)
    assert (got[B - 1, 3:] == -1).all()
    plan = lambda out: [ln for ln in out if not ln.startswith("[serve] per-step plan")]  # noqa: E731
    for r, rep in enumerate(ranks):
        assert plan([ln for ln in rep["lines"] if DRILL_LINE.match(ln)]) == plan(lines), r
        assert _drill_values(rep["metrics"]) == values, r
    assert plan(lines)[0] == "[serve] scenario 'generated-3' (seed 3): 4 events"


def test_an_expert_axis_that_cannot_serve_the_experts_is_refused():
    """mixtral's 4 smoke experts on a model axis of 2: tp_adapt gives
    ep_shards 1, and one virtual expert a device needs 4."""
    with pytest.raises(ValueError, match="must hold E x ep_shards = 4 devices"):
        serve.main(["--arch", MIXTRAL, "--smoke", "--device", "cpu", "--mesh-shape", "4,2"])
