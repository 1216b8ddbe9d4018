"""Fitting postal / max-rate models from (size, time) measurements.

The paper fits alpha/beta per protocol segment by linear least squares on
ping-pong measurements.  We reproduce that machinery so the planner can be
re-parameterized from live microbenchmarks (``core/benchmark.py``) on any
machine, and validate it by round-tripping the paper's own constants.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.params import PostalParams, Protocol
from repro_torch.core.postal import SegmentedPostalModel


def fit_postal(sizes: Sequence[float], times: Sequence[float]) -> PostalParams:
    """Least-squares fit of T = alpha + beta*s.  alpha clamped to >= 0."""
    s = np.asarray(sizes, np.float64)
    t = np.asarray(times, np.float64)
    if s.size == 0:
        raise ValueError("no samples")
    if s.size == 1:
        return PostalParams(alpha=float(t[0]), beta=0.0)
    A = np.stack([np.ones_like(s), s], axis=1)
    # Weight small messages up so alpha is determined by the latency regime
    # rather than swamped by large-size residuals (paper fits per segment,
    # segments are narrow; weighting keeps the fit stable across a segment).
    w = 1.0 / np.maximum(t, 1e-12)
    Aw = A * w[:, None]
    tw = t * w
    coef, *_ = np.linalg.lstsq(Aw, tw, rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])
    return PostalParams(alpha=max(alpha, 0.0), beta=max(beta, 0.0))


def fit_segmented(
    sizes: Sequence[float],
    times: Sequence[float],
    short_max: float,
    eager_max: float,
) -> SegmentedPostalModel:
    """Fit one postal segment per protocol window."""
    s = np.asarray(sizes, np.float64)
    t = np.asarray(times, np.float64)
    segs = {}
    masks = {
        Protocol.SHORT: s <= short_max,
        Protocol.EAGER: (s > short_max) & (s <= eager_max),
        Protocol.REND: s > eager_max,
    }
    fallback = fit_postal(s, t)
    for proto, mask in masks.items():
        segs[proto] = fit_postal(s[mask], t[mask]) if mask.any() else fallback
    return SegmentedPostalModel(segments=segs, short_max=short_max, eager_max=eager_max)


def fit_transport_model(
    sizes: Sequence[float],
    times: Sequence[float],
    thresholds: "Tuple[float, float] | str | None" = None,
):
    """Fit a tier model from ping-pong samples.

    ``thresholds``: a (short_max, eager_max) pair fits one postal segment
    per protocol window; ``"detect"`` locates the switch points with
    :func:`detect_breakpoints` first; ``None`` fits a single segment
    (:class:`repro_torch.core.postal.SimplePostalModel`).
    """
    from repro_torch.core.postal import SimplePostalModel

    if thresholds == "detect":
        bps = detect_breakpoints(sizes, times)
        thresholds = (bps[0], bps[1]) if len(bps) >= 2 else None
    if thresholds is None:
        return SimplePostalModel(fit_postal(sizes, times))
    short_max, eager_max = thresholds
    return fit_segmented(sizes, times, short_max, eager_max)


def _weighted_linfit_sse(prefix: np.ndarray, i: int, j: int) -> float:
    """Weighted-LS residual of T = a + b*s over samples [i, j).

    ``prefix`` holds cumulative sums of (w, w*s, w*s^2, w*t, w*s*t, w*t^2)
    with w = 1/t^2 (relative residuals, matching :func:`fit_postal`'s
    weighting), so each window's normal equations close in O(1).
    """
    Sw, Sws, Swss, Swt, Swst, Swtt = prefix[j] - prefix[i]
    det = Sw * Swss - Sws * Sws
    if det <= 0 or not np.isfinite(det):
        # degenerate window (e.g. all samples at one size): constant fit
        a = Swt / Sw if Sw > 0 else 0.0
        return float(Swtt - a * Swt)
    a = (Swt * Swss - Swst * Sws) / det
    b = (Sw * Swst - Sws * Swt) / det
    # SSE identity for the LS solution: sum w*t^2 - a*sum w*t - b*sum w*s*t
    return float(max(Swtt - a * Swt - b * Swst, 0.0))


def detect_breakpoints(
    sizes: Sequence[float], times: Sequence[float], n_break: int = 2
) -> Tuple[float, ...]:
    """Locate protocol switch points by piecewise-postal residual search.

    Considers every segmentation of the size-sorted samples into
    ``n_break + 1`` contiguous windows, scores each by the total weighted
    least-squares residual of one postal fit (T = alpha + beta*s) per
    window, and returns the breakpoints of the best segmentation — the
    geometric midpoint between the samples flanking each window edge, so
    downstream threshold masks (``s <= short_max``) split exactly there.

    This replaces the old largest-log-jump heuristic, which keyed on single
    noisy samples; the residual search uses every sample in every window and
    survives multiplicative measurement noise (regression test:
    ``tests/test_fitting.py::test_detect_breakpoints_noisy_regression``).
    """
    s = np.asarray(sizes, np.float64)
    t = np.asarray(times, np.float64)
    order = np.argsort(s)
    s, t = s[order], t[order]
    n = int(s.size)
    # at least 3 samples per window so no segment can chase one noisy point
    min_seg = 3
    while n_break > 0 and n < (n_break + 1) * min_seg:
        n_break -= 1
    if n_break == 0:
        return tuple()

    w = 1.0 / np.maximum(t, 1e-30) ** 2
    terms = np.stack([w, w * s, w * s * s, w * t, w * s * t, w * t * t], axis=1)
    prefix = np.zeros((n + 1, 6), np.float64)
    np.cumsum(terms, axis=0, out=prefix[1:])

    # DP over segment ends: best[k][j] = min residual covering [0, j) with k
    # windows; O(n_break * n^2) with O(1) window scoring.
    INF = float("inf")
    best = np.full((n_break + 1, n + 1), INF)
    back = np.zeros((n_break + 1, n + 1), np.int64)
    for j in range(min_seg, n + 1):
        best[0, j] = _weighted_linfit_sse(prefix, 0, j)
    for k in range(1, n_break + 1):
        for j in range((k + 1) * min_seg, n + 1):
            lo, hi = k * min_seg, j - min_seg + 1
            for i in range(lo, hi):
                cand = best[k - 1, i] + _weighted_linfit_sse(prefix, i, j)
                if cand < best[k, j]:
                    best[k, j] = cand
                    back[k, j] = i
    if not np.isfinite(best[n_break, n]):
        return tuple()
    cuts = []
    j = n
    for k in range(n_break, 0, -1):
        i = int(back[k, j])
        cuts.append(i)
        j = i
    cuts.reverse()
    return tuple(float(np.sqrt(s[i - 1] * s[i])) for i in cuts)


def fit_maxrate_beta_N(
    ppn_values: Sequence[int],
    times: Sequence[float],
    nbytes: float,
    beta_p: float,
    alpha: float,
) -> float:
    """Recover the injection cap beta_N from times at increasing ppn.

    In the capped regime T ~= alpha + ppn*beta_N*s, so beta_N is the slope of
    (T - alpha) / s against ppn over the saturated points.
    """
    ppn = np.asarray(ppn_values, np.float64)
    t = np.asarray(times, np.float64)
    y = (t - alpha) / nbytes
    # Saturated points: those where the observed per-byte cost exceeds beta_p.
    sat = y > beta_p * 1.05
    if sat.sum() < 2:
        # cap never reached (paper: Lassen inter-GPU)
        return float("nan")
    coef, *_ = np.linalg.lstsq(ppn[sat][:, None], y[sat], rcond=None)
    return float(coef[0])


@dataclasses.dataclass
class FitReport:
    params: Mapping[str, PostalParams]
    max_rel_err: float

    def __str__(self) -> str:
        rows = [f"  {k}: alpha={p.alpha:.3e}s beta={p.beta:.3e}s/B" for k, p in self.params.items()]
        return "\n".join(rows + [f"  max_rel_err={self.max_rel_err:.3f}"])


def round_trip_check(model: SegmentedPostalModel, n: int = 64, noise: float = 0.0, seed: int = 0):
    """Generate samples from a model (+ multiplicative noise) and re-fit.

    Returns (fitted_model, max relative parameter error over segments).
    """
    rng = np.random.default_rng(seed)
    sizes = np.unique(np.logspace(0, 8, n).astype(np.int64)).astype(np.float64)
    times = np.asarray(model.time(sizes))
    if noise:
        times = times * (1.0 + noise * rng.standard_normal(times.shape))
    fitted = fit_segmented(sizes, times, model.short_max, model.eager_max)
    errs = []
    for proto in Protocol:
        a0, b0 = model.segments[proto].alpha, model.segments[proto].beta
        a1, b1 = fitted.segments[proto].alpha, fitted.segments[proto].beta
        if a0 > 0:
            errs.append(abs(a1 - a0) / a0)
        if b0 > 0:
            errs.append(abs(b1 - b0) / b0)
    return fitted, float(max(errs)) if errs else 0.0
