"""The control: the reference in the program's place with every weight
product in float8 e4m3 (``reference.precision.fp8_linear``), the precision
below the configurations' bf16.  It must fail the limit that the program
passes: at smoke width on the CPU, and at each cell's own size on the card
(``calibrate.readings``, the readings the limits were set from)."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, make_copy

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


# the dense smoke model in bf16: its program reads mean gaps of 0 to 6.3e-5
# on seeds 1-12, the control 1.87e-3 to 4.36e-2 (the MoE smoke model's bf16
# gaps overlap the control's: at d_model 64 rounding flips its routes)
SMOKE_MEAN_LIMIT = 6e-4


def test_control_fails_where_the_program_passes_smoke(tmp_path):
    from perfbench.calibrate import readings

    make_copy(tmp_path, dtype="bfloat16")
    seeds = [3, 4, 2**31 + 17]
    out = readings("tiny-dense.smoke", seeds, seeds, device="cpu", root=tmp_path)
    for seed in seeds:
        assert out["program"][seed]["mean_logit_gap"] <= SMOKE_MEAN_LIMIT
        assert out["control"][seed]["mean_logit_gap"] > SMOKE_MEAN_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at its own size on the card")
    from perfbench.calibrate import readings
    from perfbench.spec import Spec

    checks = Spec(ROOT).cell(cell).checks
    seed = 2**31 + 101
    out = readings(cell, [seed], [seed])
    assert all(out["program"][seed][n] <= c["limit"] for n, c in checks.items())
    assert any(out["control"][seed][n] > c["limit"] for n, c in checks.items())
