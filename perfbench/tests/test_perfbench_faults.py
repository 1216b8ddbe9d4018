"""A run with the timed path broken underneath must come out not correct.
Each fault is planted in the port's serving path on the CPU at smoke width;
the rest of the run is the harness's own (``harness.run_cell``, everything
but the look for a card)."""
from __future__ import annotations

import pytest
import torch

from conftest import smoke_run


def _token_altered(monkeypatch):
    """Step 2's pick replaced, where the step produces it, by a token half
    the vocabulary away."""
    from repro_torch.models import decode

    step = decode.DecodeGraph._step

    def altered(self):
        logits = step(self)
        if int(self.pos) - int(self.start) == 3:
            self.token.copy_((self.token + logits.shape[-1] // 2) % logits.shape[-1])
        return logits

    monkeypatch.setattr(decode.DecodeGraph, "_step", altered)


def _state_unchanged(monkeypatch):
    """Each decode step reads the caches but writes nothing back."""
    from repro_torch.models import decode

    real = decode.decode_step

    def stale(cfg, params, caches, token, pos, dist=None):
        copies = tuple(_clone(c) for c in caches)
        return real(cfg, params, copies, token, pos, dist)[0], caches

    monkeypatch.setattr(decode, "decode_step", stale)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _half_batch(monkeypatch):
    """Prefill computes the first half of the batch and gives its results to
    the other half too."""
    from repro_torch.models import decode

    real = decode.prefill

    def half(cfg, params, tokens, **kw):
        h = tokens.shape[0] // 2
        logits, caches = real(cfg, params, tokens[:h], **kw)
        B = tokens.shape[0]

        def widen(t):  # the batch axis is the one of size h after the stacking axis
            if t.dim() >= 2 and t.shape[1] == h:
                return torch.cat([t, t[:, : B - h]], dim=1)
            return t

        caches = tuple(tuple({k: widen(v) for k, v in d.items()} for d in g) for g in caches)
        return torch.cat([logits, logits[: B - h]]), caches

    monkeypatch.setattr(decode, "prefill", half)


@pytest.mark.parametrize("cell", ["tiny-moe.smoke", "tiny-dense.smoke"])
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch])
def test_a_broken_path_is_not_correct(bench_copy, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = smoke_run(bench_copy, cell)
    assert out["correct"] is False and out["failed"] > 0
    assert any(c["value"] > c["limit"] for c in out["checked"].values())


@pytest.mark.parametrize("cell", ["tiny-moe.smoke", "tiny-dense.smoke"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 21])
def test_the_sound_path_is_correct(bench_copy, cell, seed):
    out = smoke_run(bench_copy, cell, seed=seed)
    assert out["correct"] is True and out["failed"] == 0
