"""Max-rate model (paper Eq. 2) and the multi-message extension (Eq. 3).

Eq. (2) as printed in the paper is garbled; we implement the reconstruction
documented in DESIGN.md §2.1.  With per-byte costs (s/B):

    T(s, ppn) = alpha + max(ppn * beta_N, beta_p) * s

where ``s`` is the bytes sent *per process*, ``ppn`` the number of processes
injecting on the node, ``beta_p`` the per-process transport cost and
``beta_N`` the node-aggregate injection cost (Table III).  Equivalently with
rates R = 1/beta:  T = alpha + ppn*s / min(R_N, ppn*R_p).  When
``ppn * beta_N <= beta_p`` (node cap not reached) this reduces to the postal
model, Eq. (1).

Multi-message model (Eq. 3): sending ``n`` messages per process pays the
latency n times while the bandwidth term depends only on total bytes:

    T(s, n, ppn) = alpha * n + max(ppn * beta_N, beta_p) * (n * s)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class MaxRateParams:
    alpha: float  # seconds per message
    beta_p: float  # s/B per-process transport
    beta_N: Optional[float]  # s/B node-aggregate injection; None = uncapped

    def effective_beta(self, ppn) -> np.ndarray:
        ppn = np.asarray(ppn, dtype=np.float64)
        if self.beta_N is None:
            return np.broadcast_to(np.float64(self.beta_p), ppn.shape)
        return np.maximum(ppn * self.beta_N, self.beta_p)


def maxrate_time(params: MaxRateParams, nbytes, ppn=1) -> np.ndarray:
    """Eq. (2): time for each process to send ``nbytes`` with ppn active."""
    s = np.asarray(nbytes, dtype=np.float64)
    return params.alpha + params.effective_beta(ppn) * s


def multi_message_time(params: MaxRateParams, nbytes_per_msg, n_msgs, ppn=1) -> np.ndarray:
    """Eq. (3): n messages of ``nbytes_per_msg`` from each of ppn processes."""
    s = np.asarray(nbytes_per_msg, dtype=np.float64)
    n = np.asarray(n_msgs, dtype=np.float64)
    return params.alpha * n + params.effective_beta(ppn) * (n * s)


def node_split_time(params: MaxRateParams, total_bytes, ppn, n_msgs_total=1) -> np.ndarray:
    """Cost of moving ``total_bytes`` off one node split evenly over ppn
    processes (paper Fig 4).  Message count is likewise split when the
    strategy allows it (Alltoallv point-to-point case)."""
    total = np.asarray(total_bytes, dtype=np.float64)
    ppn_arr = np.asarray(ppn, dtype=np.float64)
    s_each = total / ppn_arr
    n_each = np.maximum(np.asarray(n_msgs_total, np.float64) / ppn_arr, 1.0)
    return multi_message_time(params, s_each / n_each, n_each, ppn_arr)


def saturating_ppn(params: MaxRateParams) -> Optional[float]:
    """ppn at which the node injection cap starts to bind (ppn*beta_N >= beta_p)."""
    if params.beta_N is None or params.beta_N == 0.0:
        return None
    return params.beta_p / params.beta_N
