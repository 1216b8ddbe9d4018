"""Deterministic synthetic data pipeline, copied from ``repro.data.synthetic``.

Every batch is a pure function of (seed, step) via counter-based Philox
RNG, so a restarted (or re-sharded, or elastically re-scaled) run replays
the exact token stream from any step — the property the fault-tolerance
tests assert (bitwise identical training resume).  numpy only, so one
``seed`` gives the port and the JAX package the same batches bit for bit;
``launch.train`` moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Zipf-ish token stream with document structure (BOS/EOS markers) so
    losses are non-degenerate and embeddings see a realistic frequency tilt."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0
    mean_doc_len: int = 512

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=np.uint64(step))
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # Zipf-like marginal: rank r gets p ~ 1/(r+10)
        ranks = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        tokens = np.minimum(ranks + 2, V - 1).astype(np.int32)  # 0=BOS, 1=EOS
        # insert document boundaries
        n_docs = max(B * S // self.mean_doc_len, 1)
        bi = rng.integers(0, B, size=n_docs)
        si = rng.integers(0, S, size=n_docs)
        tokens[bi, si] = 1
        tokens[:, 0] = 0
        out = {"tokens": tokens}
        if self.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (B, self.frontend_tokens, self.frontend_dim), dtype=np.float32
            )
        return out
