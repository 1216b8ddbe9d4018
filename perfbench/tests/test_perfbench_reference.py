"""The plain reference (``perfbench/reference``) against the port's CPU path
at smoke width in float32: prefill's last-position logits and every
decode step's, for a mixture-of-experts model with RMSNorm and a window and
for a dense one with non-parametric LayerNorm and a tied head."""
from __future__ import annotations

import pytest
import torch

from conftest import tiny_model
from perfbench import weights
from perfbench.reference import decoder, precision

# float32 on both sides; the two sum in different orders (the port's masked
# softmax over a padded cache, its expert outputs weighted over all experts)
F32_TOL = 1e-4


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-dense"])
@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_reference_matches_the_port_f32(name, seed):
    from perfbench.harness import port_config
    from repro_torch.models import decode

    model = tiny_model(name, dtype="float32")
    cfg = port_config(model)
    params = weights.draw(decoder, model, seed, "cpu")
    B, P, N = 3, 17, 5
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(2, model["vocab_size"], (B, P), generator=gen, dtype=torch.int32)
    with torch.no_grad():
        first, caches = decode.prefill(cfg, params, prompt, capacity=P + N)
        steps = decode.DecodeGraph(cfg, params, caches, first.argmax(-1)[:, None], P, N)
        port = [first] + [steps.step().clone() for _ in range(N)]
        seq = torch.cat([prompt.long(), steps.tokens], dim=1)  # every token fed
        precision.set_precision()
        ref = decoder.logits(model, params, seq, P - 1)
    assert ref.shape == (B, N + 1, decoder.vocab_rows(model))
    got = torch.stack(port, dim=1)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= F32_TOL * max(scale, 1.0)


def test_fp8_control_rounds_every_weight_product():
    x = torch.randn(5, 64)
    w = torch.randn(64, 32)
    exact = precision.f32_linear(x, w)
    low = precision.fp8_linear(x, w)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 0.01 < rel < 0.2  # e4m3 keeps 3 mantissa bits
    assert torch.equal(precision.fp8_linear(x, w), low)
