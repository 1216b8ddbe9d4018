"""Communication-path cost composition (paper §III-§V), machine-agnostic.

Every path is a :class:`repro_torch.core.machine.Path` — an explicit composition
of transport-tier traversals — evaluated by the generic
:func:`repro_torch.core.machine.path_time`.  The functions here are the stable
public API; they resolve machines purely through the registry
(:func:`get_machine` / :func:`machine_for`), so adding a machine is a
registry entry, never an edit to this file.

Named paths of the built-in families:

* GPU machines: ``gpudirect`` (one postal hop on the GPU NIC tier) and
  ``three_step`` (``copy_d2h -> cpu_net -> copy_h2d``, optionally split
  over CPU cores, subject to the Table III injection cap).
* TPU pods: ``direct`` (every chip injects over DCN), ``staged``
  (``ici -> dcn -> ici``, the 3-step analogue), ``multirail`` (all host
  NICs inject equal shares, the Dup-Devptr analogue).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.machine import (
    MachineSpec,
    machine_for,
    path_time,
    resolve_spec as _spec,
)
from repro_torch.core.maxrate import MaxRateParams
from repro_torch.core.params import CopyDirection, Locality
from repro_torch.core.topology import TpuPodTopology


# --------------------------------------------------------------------------
# Tier-level helpers (kept for fitting/benchmarks; registry-backed).
# --------------------------------------------------------------------------

def gpu_maxrate(machine, locality: Locality, nbytes: float) -> MaxRateParams:
    """Max-rate params of the GPU NIC tier at one message size."""
    return _spec(machine).resolve_tier("gpu_net", locality).maxrate(nbytes)


def cpu_maxrate(machine, locality: Locality, nbytes: float) -> MaxRateParams:
    """Max-rate params of the CPU NIC tier at one message size."""
    return _spec(machine).resolve_tier("cpu_net", locality).maxrate(nbytes)


_COPY_TIER = {CopyDirection.D2H: "copy_d2h", CopyDirection.H2D: "copy_h2d"}


def memcpy_time(machine, direction: CopyDirection, nbytes, on_socket: bool = True) -> np.ndarray:
    """Copy-tier postal time (Table II on the paper machines)."""
    socket = "on-socket" if on_socket else "off-socket"
    tier = _spec(machine).resolve_tier(_COPY_TIER[direction], socket=socket)
    return tier.time(np.asarray(nbytes, np.float64))


# --------------------------------------------------------------------------
# Path costs.
# --------------------------------------------------------------------------

def gpudirect_time(
    machine,
    nbytes_per_msg,
    n_msgs=1,
    ppn_gpus: int = 1,
    locality: Locality = Locality.OFF_NODE,
) -> np.ndarray:
    """Direct device-NIC path, Eq. (3) with the inter-GPU injection cap.

    ``ppn_gpus`` = GPUs per node actively injecting (6 on Summit, 4 Lassen).
    """
    return path_time(
        _spec(machine), "gpudirect", nbytes_per_msg, n_msgs,
        concurrency=ppn_gpus, locality=locality,
    )


def three_step_time(
    machine,
    nbytes_per_msg,
    n_msgs=1,
    cores_per_gpu: int = 1,
    ppn_gpus: int = 1,
    on_socket_copy: bool = True,
    locality: Locality = Locality.OFF_NODE,
    dedup_factor: float = 1.0,
) -> np.ndarray:
    """3-step path: D2H copy (once), CPU send(s), H2D copy (once).

    * The memcpy is paid once for the union of the data (``dedup_factor`` < 1
      models duplicated values across messages: copied bytes = total/dedup).
    * ``cores_per_gpu`` CPU cores split the bytes — paper §IV/§VI.
    * ``ppn_gpus`` GPUs per node each feed their own core group; the CPU
      injection cap sees ppn = cores_per_gpu * ppn_gpus active processes.
    """
    return path_time(
        _spec(machine), "three_step", nbytes_per_msg, n_msgs,
        lanes=cores_per_gpu, concurrency=ppn_gpus, locality=locality,
        socket="on-socket" if on_socket_copy else "off-socket",
        dedup_factor=dedup_factor,
    )


# --------------------------------------------------------------------------
# TPU adapter (back-compat facade over the registry spec for a topology).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuPathModels:
    """Path costs for a TPU topology, resolved through the registry."""

    topo: TpuPodTopology

    @property
    def spec(self) -> MachineSpec:
        return machine_for(self.topo)

    @property
    def sys(self):
        return self.topo.system

    def ici_time(self, nbytes, hops: int = 1, links: int = 1) -> np.ndarray:
        """Move nbytes over `links` parallel ICI links, `hops` hops deep."""
        tier = self.spec.resolve_tier("ici")
        p = tier.params_for(0.0)
        s = np.asarray(nbytes, np.float64)
        alpha = p.alpha + self.spec.fact("ici_hop_alpha") * max(hops - 1, 0)
        return alpha + s * p.beta / links

    def dcn_params(self, hosts_injecting: int) -> MaxRateParams:
        """Max-rate params for cross-pod DCN; the *pod-aggregate* cap beta_N
        is spread over the injecting hosts exactly like the paper's NIC cap
        over CPU cores."""
        return self.spec.resolve_tier("dcn").maxrate(0.0)

    def tpu_direct_time(self, nbytes_per_chip, n_msgs=1) -> np.ndarray:
        """Every chip sends its slice cross-pod: all hosts inject, but each
        message is small, and each of n_msgs pays the DCN latency."""
        return path_time(self.spec, "direct", nbytes_per_chip, n_msgs)

    def tpu_staged_time(self, nbytes_per_chip, n_msgs=1) -> np.ndarray:
        """Gather the pod's payload to one host's chips over ICI, send one
        DCN stream, scatter on the far side (3-step analogue)."""
        return path_time(self.spec, "staged", nbytes_per_chip, n_msgs)

    def tpu_multirail_time(self, nbytes_per_chip, n_msgs=1) -> np.ndarray:
        """Slice re-bucketed so all hosts inject equal shares of ONE logical
        message (Dup-Devptr analogue)."""
        return path_time(self.spec, "multirail", nbytes_per_chip, n_msgs)
