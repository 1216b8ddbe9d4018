"""Measured model parameters, verbatim from the paper (Tables I, II, III).

This module is pure data: the tables keyed by machine name.  The executable
view of a machine — transport tiers, paths, strategies — is built from
these tables by :mod:`repro_torch.core.machine` and addressed through its
registry; nothing outside that module should branch on machine names.

Units:
  * ``alpha`` — seconds (per-message start-up latency).
  * ``beta``  — seconds per byte (inverse bandwidth).
  * ``beta_N`` — seconds per byte of *node-aggregate* network injection
    (Table III).  The paper's Table III header says "bytes/sec" but the
    magnitudes (~3e-11) are unambiguously s/B; see DESIGN.md §2.1.

Protocol switch points (message size in bytes) follow the MPI defaults the
paper benchmarks under: Spectrum MPI short->eager at the envelope size and
eager->rendezvous near 64 KiB; MVAPICH2-GDR has no separate short segment in
the paper's tables.  The exact switch points only shape which (alpha, beta)
segment is active; fitted crossovers in the benchmarks are insensitive to
+-2x changes of these thresholds (tested).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping


class Protocol(enum.Enum):
    SHORT = "short"
    EAGER = "eager"
    REND = "rend"


class Locality(enum.Enum):
    """Locality classes of the paper's Fig 2 / Table I."""

    ON_SOCKET = "on-socket"
    ON_NODE = "on-node"
    OFF_NODE = "off-node"


@dataclasses.dataclass(frozen=True)
class PostalParams:
    """One (alpha, beta) postal segment: T = alpha + beta * s."""

    alpha: float  # seconds
    beta: float  # seconds / byte
    suspect: bool = False  # verbatim-but-physically-odd paper value

    def time(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes


# --------------------------------------------------------------------------
# Table I: inter-CPU and inter-GPU (GPUDirect) message passing.
# dict[machine][cpu|gpu][protocol][locality] -> PostalParams
# --------------------------------------------------------------------------

TABLE_I: Mapping[str, Mapping[str, Mapping[Protocol, Mapping[Locality, PostalParams]]]] = {
    "summit": {
        "cpu": {
            Protocol.SHORT: {
                Locality.ON_SOCKET: PostalParams(3.51e-07, 2.62e-10),
                Locality.ON_NODE: PostalParams(9.08e-07, 1.46e-09),
                Locality.OFF_NODE: PostalParams(1.38e-06, 3.82e-10),
            },
            Protocol.EAGER: {
                Locality.ON_SOCKET: PostalParams(4.73e-07, 6.95e-11),
                Locality.ON_NODE: PostalParams(1.17e-06, 2.16e-10),
                Locality.OFF_NODE: PostalParams(1.85e-06, 2.93e-10),
            },
            Protocol.REND: {
                Locality.ON_SOCKET: PostalParams(2.46e-06, 3.31e-11),
                Locality.ON_NODE: PostalParams(5.81e-06, 1.46e-10),
                Locality.OFF_NODE: PostalParams(6.56e-06, 8.51e-11),
            },
        },
        # Paper: "messaging protocol delineation for inter-GPU communication
        # on Summit has been excluded due to an insignificant difference".
        # One segment used for all protocols.
        "gpu": {
            proto: {
                Locality.ON_SOCKET: PostalParams(1.68e-05, 1.86e-11),
                Locality.ON_NODE: PostalParams(1.80e-05, 2.09e-11),
                Locality.OFF_NODE: PostalParams(4.96e-06, 1.69e-10),
            }
            for proto in Protocol
        },
    },
    "lassen": {
        "cpu": {
            # MVAPICH2-GDR tables give eager + rendezvous only; short==eager.
            Protocol.SHORT: {
                Locality.ON_SOCKET: PostalParams(3.99e-07, 5.59e-11),
                Locality.ON_NODE: PostalParams(7.07e-07, 2.23e-10),
                Locality.OFF_NODE: PostalParams(1.53e-06, 4.38e-10),
            },
            Protocol.EAGER: {
                Locality.ON_SOCKET: PostalParams(3.99e-07, 5.59e-11),
                Locality.ON_NODE: PostalParams(7.07e-07, 2.23e-10),
                Locality.OFF_NODE: PostalParams(1.53e-06, 4.38e-10),
            },
            Protocol.REND: {
                Locality.ON_SOCKET: PostalParams(3.62e-06, 3.71e-11),
                Locality.ON_NODE: PostalParams(1.07e-05, 1.42e-10),
                Locality.OFF_NODE: PostalParams(6.90e-06, 4.63e-11),
            },
        },
        "gpu": {
            Protocol.SHORT: {
                Locality.ON_SOCKET: PostalParams(7.09e-07, 5.79e-11),
                Locality.ON_NODE: PostalParams(1.04e-06, 2.15e-10),
                Locality.OFF_NODE: PostalParams(2.11e-06, 4.91e-10),
            },
            Protocol.EAGER: {
                Locality.ON_SOCKET: PostalParams(7.09e-07, 5.79e-11),
                Locality.ON_NODE: PostalParams(1.04e-06, 2.15e-10),
                Locality.OFF_NODE: PostalParams(2.11e-06, 4.91e-10),
            },
            Protocol.REND: {
                Locality.ON_SOCKET: PostalParams(6.39e-06, 3.38e-11),
                # Verbatim paper value; physically odd (faster than on-socket).
                Locality.ON_NODE: PostalParams(2.61e-05, 4.59e-13, suspect=True),
                Locality.OFF_NODE: PostalParams(6.87e-06, 4.73e-11),
            },
        },
    },
}

# Protocol switch thresholds in bytes (per machine, CPU path).  GPU paths on
# Summit are single-segment (see above); on Lassen eager->rend near 32 KiB.
PROTOCOL_THRESHOLDS: Mapping[str, Mapping[str, tuple]] = {
    # (short_max, eager_max): s <= short_max -> SHORT; s <= eager_max -> EAGER
    "summit": {"cpu": (4096, 65536), "gpu": (4096, 65536)},
    "lassen": {"cpu": (4096, 32768), "gpu": (4096, 32768)},
}


# --------------------------------------------------------------------------
# Table II: cudaMemcpyAsync postal parameters.
# dict[machine][socket][direction] -> PostalParams
# --------------------------------------------------------------------------

class CopyDirection(enum.Enum):
    H2D = "HostToDevice"
    D2H = "DeviceToHost"


TABLE_II: Mapping[str, Mapping[str, Mapping[CopyDirection, PostalParams]]] = {
    "summit": {
        "on-socket": {
            CopyDirection.H2D: PostalParams(1.09e-05, 2.38e-11),
            CopyDirection.D2H: PostalParams(1.09e-05, 2.36e-11),
        },
        "off-socket": {
            CopyDirection.H2D: PostalParams(1.26e-05, 2.71e-11),
            CopyDirection.D2H: PostalParams(1.25e-05, 2.72e-11),
        },
    },
    "lassen": {
        "on-socket": {
            CopyDirection.H2D: PostalParams(1.33e-05, 1.80e-11),
            CopyDirection.D2H: PostalParams(1.35e-05, 1.75e-11),
        },
        "off-socket": {
            CopyDirection.H2D: PostalParams(1.42e-05, 2.84e-11),
            CopyDirection.D2H: PostalParams(1.40e-05, 2.83e-11),
        },
    },
}


# --------------------------------------------------------------------------
# Table III: injection-bandwidth caps (stored as beta_N, seconds per byte of
# node-aggregate traffic; see module docstring for the units correction).
# ``None`` -> cap never reached with available GPUs (paper: Lassen inter-GPU).
# --------------------------------------------------------------------------

TABLE_III_BETA_N: Mapping[str, Mapping[str, float]] = {
    "summit": {"cpu": 3.0e-11, "gpu": 5.1e-11},
    "lassen": {"cpu": 2.5e-11, "gpu": None},
}


# Machine shape facts from §II.
MACHINES: Mapping[str, Mapping[str, int]] = {
    "summit": {"gpus_per_node": 6, "cpu_cores_per_node": 40, "sockets": 2},
    "lassen": {"gpus_per_node": 4, "cpu_cores_per_node": 40, "sockets": 2},
}


# --------------------------------------------------------------------------
# TPU v5e target constants (the machine this framework is deployed on).
# Peak numbers per the assignment; latencies are representative published
# figures used to seed the postal models for the planner; `core/benchmark.py`
# can re-fit alpha/beta from live measurements on real hardware.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuSystem:
    name: str = "tpu_v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s per chip
    hbm_bandwidth: float = 819e9  # B/s per chip
    ici_link_bandwidth: float = 50e9  # B/s per link (per direction)
    ici_links_per_chip: int = 4  # 2D torus on v5e: 4 neighbours
    dcn_bandwidth_per_host: float = 25e9  # B/s per host NIC
    chips_per_host: int = 4
    hosts_per_pod: int = 64  # 256-chip pod = 16x16
    chips_per_pod: int = 256
    vmem_bytes: int = 128 * 1024 * 1024  # ~128 MiB VMEM per chip
    # Postal latencies (seconds): ICI neighbour hop, ICI multi-hop (cross-pod
    # diameter ~16 hops on 16x16 torus), DCN message.
    ici_alpha: float = 1.0e-06
    ici_hop_alpha: float = 1.0e-07
    dcn_alpha: float = 1.0e-05

    @property
    def ici_beta(self) -> float:
        return 1.0 / self.ici_link_bandwidth

    @property
    def dcn_beta_per_host(self) -> float:
        return 1.0 / self.dcn_bandwidth_per_host

    # Node-aggregate DCN injection cap, as beta_N (s/B) per pod: every host
    # NIC can inject concurrently (the paper's "all CPU cores" resource).
    @property
    def dcn_beta_N_pod(self) -> float:
        return 1.0 / (self.dcn_bandwidth_per_host * self.hosts_per_pod)


TPU_V5E = TpuSystem()
