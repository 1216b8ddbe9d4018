"""Machine topology descriptions.

Two families:

* :class:`GpuNodeTopology` — the paper's heterogeneous nodes (Summit/Lassen):
  GPUs + CPU cores per node, two sockets, one NIC tier.
* :class:`TpuPodTopology` — the deployment target: chips on a 2D ICI torus
  grouped into pods; hosts each driving ``chips_per_host`` chips; DCN between
  pods.  Distances between two chips map onto the paper's locality classes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

from repro_torch.core.params import Locality, MACHINES, TpuSystem, TPU_V5E


@dataclasses.dataclass(frozen=True)
class GpuNodeTopology:
    machine: str  # "summit" | "lassen"

    @property
    def gpus_per_node(self) -> int:
        return MACHINES[self.machine]["gpus_per_node"]

    @property
    def cpu_cores_per_node(self) -> int:
        return MACHINES[self.machine]["cpu_cores_per_node"]

    @property
    def sockets(self) -> int:
        return MACHINES[self.machine]["sockets"]

    @property
    def cores_per_gpu(self) -> int:
        # Paper §VI: "as Summit has 6 GPUs and 40 CPU cores per node, 6 CPU
        # cores are utilized per GPU" (integer share).
        return self.cpu_cores_per_node // self.gpus_per_node

    def locality(self, node_a: int, rank_a: int, node_b: int, rank_b: int) -> Locality:
        """Locality class of two GPU endpoints (node id, local gpu id)."""
        if node_a != node_b:
            return Locality.OFF_NODE
        per_socket = self.gpus_per_node // self.sockets
        if rank_a // per_socket == rank_b // per_socket:
            return Locality.ON_SOCKET
        return Locality.ON_NODE

    def machine_spec(self):
        """This machine's cost spec, resolved through the registry."""
        from repro_torch.core.machine import machine_for

        return machine_for(self)


SUMMIT = GpuNodeTopology("summit")
LASSEN = GpuNodeTopology("lassen")


@dataclasses.dataclass(frozen=True)
class TpuPodTopology:
    """A (pods, x, y) arrangement of TPU chips; per-pod 2D torus of x*y chips.

    ``machine`` names the registry entry (:mod:`repro_torch.core.machine`) whose
    factory builds the cost spec for this topology.
    """

    system: TpuSystem = TPU_V5E
    pods: int = 1
    torus_x: int = 16
    torus_y: int = 16
    machine: str = "tpu_v5e"

    @property
    def chips_per_pod(self) -> int:
        return self.torus_x * self.torus_y

    @property
    def total_chips(self) -> int:
        return self.pods * self.chips_per_pod

    @property
    def hosts_per_pod(self) -> int:
        # a pod smaller than one host still has one host driving it (the
        # mesh-shaped selectors produce tiny per-pod chip counts)
        return max(self.chips_per_pod // self.system.chips_per_host, 1)

    def coords(self, chip: int) -> Tuple[int, int, int]:
        """chip id -> (pod, x, y)."""
        pod, rem = divmod(chip, self.chips_per_pod)
        x, y = divmod(rem, self.torus_y)
        return pod, x, y

    def ici_hops(self, chip_a: int, chip_b: int) -> int:
        """Torus hop count between two chips of the same pod."""
        pod_a, xa, ya = self.coords(chip_a)
        pod_b, xb, yb = self.coords(chip_b)
        if pod_a != pod_b:
            raise ValueError("ici_hops is intra-pod only")
        dx = min(abs(xa - xb), self.torus_x - abs(xa - xb))
        dy = min(abs(ya - yb), self.torus_y - abs(ya - yb))
        return dx + dy

    def locality(self, chip_a: int, chip_b: int) -> Locality:
        """Map chip-pair distance onto the paper's locality classes:
        neighbour ICI hop ~ on-socket; multi-hop ICI ~ on-node; DCN ~ off-node.
        """
        pod_a = self.coords(chip_a)[0]
        pod_b = self.coords(chip_b)[0]
        if pod_a != pod_b:
            return Locality.OFF_NODE
        return Locality.ON_SOCKET if self.ici_hops(chip_a, chip_b) <= 1 else Locality.ON_NODE

    def bisection_bandwidth_pod(self) -> float:
        """Bidirectional bisection bandwidth of one pod's 2D torus (B/s)."""
        # Cut the torus along x: 2 * torus_y wrap+direct links cross the cut.
        links = 2 * self.torus_y
        return links * self.system.ici_link_bandwidth * 2  # bidirectional

    def dcn_bandwidth_pod(self) -> float:
        """Aggregate DCN injection bandwidth of one pod (all hosts; B/s)."""
        return self.hosts_per_pod * self.system.dcn_bandwidth_per_host

    def iter_chips(self) -> Iterator[int]:
        return iter(range(self.total_chips))

    def machine_spec(self):
        """This machine's cost spec, resolved through the registry."""
        from repro_torch.core.machine import machine_for

        return machine_for(self)


SINGLE_POD_V5E = TpuPodTopology(pods=1)
TWO_POD_V5E = TpuPodTopology(pods=2)
