"""Postal model (paper Eq. 1) with protocol and locality segmentation.

T(s) = alpha + beta * s, with (alpha, beta) selected by the active protocol
segment for the message size s and the locality class of the endpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.params import (
    Locality,
    PostalParams,
    Protocol,
    PROTOCOL_THRESHOLDS,
    TABLE_I,
)


def select_protocol(nbytes: float, short_max: float, eager_max: float) -> Protocol:
    if nbytes <= short_max:
        return Protocol.SHORT
    if nbytes <= eager_max:
        return Protocol.EAGER
    return Protocol.REND


@dataclasses.dataclass(frozen=True)
class SegmentedPostalModel:
    """Postal model with short/eager/rendezvous segments.

    ``segments`` maps Protocol -> PostalParams; thresholds are byte sizes.
    """

    segments: Mapping[Protocol, PostalParams]
    short_max: float
    eager_max: float

    def params_for(self, nbytes: float) -> PostalParams:
        return self.segments[select_protocol(nbytes, self.short_max, self.eager_max)]

    def time(self, nbytes) -> np.ndarray:
        """Vectorized T(s). Accepts scalar or ndarray of byte counts."""
        s = np.asarray(nbytes, dtype=np.float64)
        t_short = self.segments[Protocol.SHORT].time(s)
        t_eager = self.segments[Protocol.EAGER].time(s)
        t_rend = self.segments[Protocol.REND].time(s)
        return np.where(
            s <= self.short_max, t_short, np.where(s <= self.eager_max, t_eager, t_rend)
        )

    def alpha(self, nbytes: float) -> float:
        return self.params_for(nbytes).alpha

    def beta(self, nbytes: float) -> float:
        return self.params_for(nbytes).beta


def paper_model(
    machine: str, device: str, locality: Locality
) -> SegmentedPostalModel:
    """Build the paper's Table-I model for (machine, cpu|gpu, locality)."""
    table = TABLE_I[machine][device]
    short_max, eager_max = PROTOCOL_THRESHOLDS[machine][device]
    return SegmentedPostalModel(
        segments={proto: table[proto][locality] for proto in Protocol},
        short_max=short_max,
        eager_max=eager_max,
    )


@dataclasses.dataclass(frozen=True)
class SimplePostalModel:
    """Single-segment postal model (TPU tiers, memcpy tiers)."""

    params: PostalParams

    def time(self, nbytes) -> np.ndarray:
        s = np.asarray(nbytes, dtype=np.float64)
        return self.params.time(s)

    def params_for(self, nbytes: float = 0.0) -> PostalParams:
        return self.params

    def alpha(self, nbytes: float = 0.0) -> float:
        return self.params.alpha

    def beta(self, nbytes: float = 0.0) -> float:
        return self.params.beta


def make_simple(alpha: float, beta: float) -> SimplePostalModel:
    return SimplePostalModel(PostalParams(alpha, beta))


@dataclasses.dataclass(frozen=True)
class ScaledPostalModel:
    """A base postal model with multiplicative (alpha, beta) degradation.

    The congestion fitter (:mod:`repro_torch.obs.congestion`) expresses a sagging
    link as scale factors on the healthy model rather than a fresh fit: the
    protocol segmentation (short/eager/rendezvous thresholds) of the base
    model is preserved, only the per-segment latency/bandwidth terms move.
    ``beta_scale > 1`` means the effective bandwidth dropped by that factor.
    """

    base: "SegmentedPostalModel | SimplePostalModel"
    alpha_scale: float = 1.0
    beta_scale: float = 1.0

    def params_for(self, nbytes: float = 0.0) -> PostalParams:
        p = self.base.params_for(nbytes)
        return PostalParams(
            p.alpha * self.alpha_scale, p.beta * self.beta_scale, suspect=p.suspect
        )

    def time(self, nbytes) -> np.ndarray:
        s = np.asarray(nbytes, dtype=np.float64)
        if s.ndim == 0:
            return np.asarray(self.params_for(float(s)).time(s))
        out = np.empty_like(s)
        flat_s = s.ravel()
        flat_o = out.ravel()
        for sz in np.unique(flat_s):
            mask = flat_s == sz
            flat_o[mask] = self.params_for(float(sz)).time(flat_s[mask])
        return out

    def alpha(self, nbytes: float = 0.0) -> float:
        return self.params_for(nbytes).alpha

    def beta(self, nbytes: float = 0.0) -> float:
        return self.params_for(nbytes).beta


def crossover_size(
    m_a: "SegmentedPostalModel | SimplePostalModel",
    m_b: "SegmentedPostalModel | SimplePostalModel",
    lo: float = 1.0,
    hi: float = 1 << 34,
) -> Optional[float]:
    """Smallest message size (bytes) at which model B becomes cheaper than A.

    Returns None if B is never cheaper on [lo, hi].  Grid + bisection; the
    segmented models are piecewise-linear so a log-grid scan is exact enough
    for planner decisions (sizes are powers of two in practice).
    """
    sizes = np.logspace(np.log10(lo), np.log10(hi), 4097)
    diff = np.asarray(m_a.time(sizes)) - np.asarray(m_b.time(sizes))
    better = np.nonzero(diff > 0)[0]
    if better.size == 0:
        return None
    i = better[0]
    if i == 0:
        return float(sizes[0])
    # bisect within the bracketing interval
    lo_s, hi_s = sizes[i - 1], sizes[i]
    for _ in range(64):
        mid = 0.5 * (lo_s + hi_s)
        if float(m_a.time(mid)) - float(m_b.time(mid)) > 0:
            hi_s = mid
        else:
            lo_s = mid
    return float(hi_s)
