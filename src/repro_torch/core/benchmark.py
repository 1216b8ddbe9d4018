"""Live microbenchmarks + model fitting (the paper's measurement pipeline).

On an NVIDIA GPU these functions measure the card's real copy tiers (the
host -> device copy, ``cudaMemcpy`` under ``Tensor.to``); on the CPU
(``device="cpu"``, asked for explicitly) they exercise the identical code
path against host-to-host copies, so the fit -> model -> plan pipeline is
tested end-to-end.

:func:`spec_from_measurements` closes the loop the paper draws in §VI:
measured tiers become a registered :class:`~repro_torch.core.machine.MachineSpec`,
so a live-fitted machine plans (``repro_torch.core.planner``) exactly like
the built-in table-driven entries.

The reference's ``bench_jitted_allreduce`` (a collective timed across
devices) is not here: it needs more than one device, and comes with the
port's distribution work (ROADMAP.md, Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.fitting import fit_postal, fit_transport_model
from repro_torch.core.machine import (
    MachineSpec,
    TransportTier,
    gpu_family_paths,
    gpu_family_strategies,
    gpu_plan_variants,
    register_machine,
)
from repro_torch.core.params import PostalParams
from repro_torch.obs import drift as obs_drift


def _time_call(fn: Callable[[], None], min_time: float = 2e-3, max_reps: int = 200) -> float:
    """Paper §VI methodology: repeat until timer precision, min over trials."""
    trials = []
    for _ in range(3):
        # calibrate rep count
        t0 = time.perf_counter()
        fn()
        once = max(time.perf_counter() - t0, 1e-9)
        reps = int(min(max(min_time / once, 1), max_reps))
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        trials.append((time.perf_counter() - t0) / reps)
    return min(trials)


@dataclasses.dataclass
class BenchResult:
    sizes: List[int]
    times: List[float]
    fitted: PostalParams

    def csv_rows(self, name: str) -> List[str]:
        rows = [f"{name},{s},{t:.3e}" for s, t in zip(self.sizes, self.times)]
        rows.append(f"{name}_fit,alpha={self.fitted.alpha:.3e},beta={self.fitted.beta:.3e}")
        return rows


def bench_transfer(
    make_buffer: Callable[[int], object],
    transfer: Callable[[object], object],
    sizes: Sequence[int] = (1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 22, 1 << 24),
) -> BenchResult:
    """Measure transfer(buffer_of_size) for each size and fit a postal model."""
    measured: List[float] = []
    szs: List[int] = []
    for s in sizes:
        buf = make_buffer(s)
        t = _time_call(lambda: transfer(buf))
        measured.append(t)
        szs.append(s)
    return BenchResult(sizes=szs, times=measured, fitted=fit_postal(szs, measured))


def bench_host_device_roundtrip(
    sizes: Sequence[int] = (1 << 12, 1 << 16, 1 << 20, 1 << 23),
    device: Union[str, torch.device] = "cuda",
) -> BenchResult:
    """cudaMemcpyAsync analogue: host numpy -> torch buffer on ``device``.

    Each call copies (``copy=True``: on the CPU ``.to`` alone would return the
    same tensor and time nothing) and, on a CUDA device, waits for the copy.
    The default is the card; without a visible GPU that raises rather than
    timing the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"bench_host_device_roundtrip: device {str(dev)!r} asked for but no CUDA GPU "
            "is visible (torch.cuda.is_available() is False); pass device='cpu' to "
            "time host-to-host copies instead"
        )
    on_cuda = dev.type == "cuda"

    def make(s: int):
        return np.zeros(s, np.uint8)

    def put(buf):
        torch.from_numpy(buf).to(dev, copy=True)
        if on_cuda:
            torch.cuda.synchronize(dev)

    return bench_transfer(make, put, sizes)


# --------------------------------------------------------------------------
# Measurements -> registered machine (the paper's §VI loop, closed).
# --------------------------------------------------------------------------

Samples = Union["BenchResult", Tuple[Sequence[float], Sequence[float]]]


def _samples(data: Samples) -> Tuple[Sequence[float], Sequence[float]]:
    if isinstance(data, BenchResult):
        return data.sizes, data.times
    sizes, times = data
    return sizes, times


def spec_from_measurements(
    name: str,
    direct_net: Samples,
    *,
    staged_net: Optional[Samples] = None,
    copy_d2h: Optional[Samples] = None,
    copy_h2d: Optional[Samples] = None,
    placed_pairs: Optional[Dict[str, Samples]] = None,
    direct_beta_N: Optional[float] = None,
    staged_beta_N: Optional[float] = None,
    injectors_per_node: int = 1,
    lanes_per_injector: int = 1,
    thresholds=None,
    register: bool = True,
) -> MachineSpec:
    """Build (and by default register) a MachineSpec from measured tiers.

    * ``direct_net`` — ping-pong (size, time) samples of the direct
      device-to-device path (the GPUDirect analogue).
    * ``staged_net`` + ``copy_d2h``/``copy_h2d`` — the staging network tier
      and the host<->device copy tiers; when all three are present the spec
      also declares the 3-step family (``three_step``/``extra_msg``/
      ``dup_devptr``) and the Fig-5 crossover becomes measurable.
    * ``placed_pairs`` — locality-split ping-pong samples of the direct
      path, keyed by placement class (``"on-socket"``, ``"on-node"``,
      ``"off-node"``): pairs pinned on-socket, across sockets of one node,
      and across nodes.  Each class fits its own ``gpu_net:{class}`` tier,
      so :meth:`~repro_torch.core.machine.MachineSpec.resolve_tier` picks the
      placement-correct model exactly as it does for the paper's Table-I
      localities — a degraded machine can be *fitted* per locality live,
      not just declared (ROADMAP item 5).
    * ``direct_beta_N``/``staged_beta_N`` — injection caps, e.g. from
      :func:`repro_torch.core.fitting.fit_maxrate_beta_N` on a ppn sweep (NaN is
      treated as "cap never reached").
    * ``injectors_per_node``/``lanes_per_injector`` — shape facts: devices
      injecting per node, and staging lanes (CPU cores) per device.
    * ``thresholds`` — protocol switch points for the net tiers: a
      ``(short_max, eager_max)`` pair, ``"detect"``, or None (one segment);
      see :func:`repro_torch.core.fitting.fit_transport_model`.

    The result plans and simulates through the exact code paths the
    built-in machines use — registry in, planner out.
    """
    def cap(v: Optional[float]) -> Optional[float]:
        return None if v is None or (isinstance(v, float) and np.isnan(v)) else v

    staged_family = staged_net is not None and copy_d2h is not None and copy_h2d is not None
    tiers: Dict[str, TransportTier] = {
        "gpu_net": TransportTier(
            name="gpu_net",
            model=fit_transport_model(*_samples(direct_net), thresholds=thresholds),
            beta_N=cap(direct_beta_N),
            width=injectors_per_node,
        ),
    }
    if staged_family:
        tiers["cpu_net"] = TransportTier(
            name="cpu_net",
            model=fit_transport_model(*_samples(staged_net), thresholds=thresholds),
            beta_N=cap(staged_beta_N),
            width=lanes_per_injector,
        )
        for tier_name, data in (("copy_d2h", copy_d2h), ("copy_h2d", copy_h2d)):
            tiers[tier_name] = TransportTier(
                name=tier_name,
                model=fit_transport_model(*_samples(data), thresholds=None),
                width=lanes_per_injector,
                serialize_alpha=True,
            )
    if placed_pairs:
        for loc_key, data in placed_pairs.items():
            tier_key = f"gpu_net:{loc_key}"
            tiers[tier_key] = TransportTier(
                name=tier_key,
                model=fit_transport_model(*_samples(data), thresholds=thresholds),
                beta_N=cap(direct_beta_N),
                width=injectors_per_node,
            )
    # fitted-vs-measured residuals per tier: every sample the fit consumed
    # becomes a drift record, so the fit quality itself is visible to
    # run.py --compare (a tier whose model stops matching its own samples
    # is the first sign of a bad protocol-threshold split)
    tier_samples = {"gpu_net": direct_net}
    if staged_family:
        tier_samples.update(
            cpu_net=staged_net, copy_d2h=copy_d2h, copy_h2d=copy_h2d
        )
    if placed_pairs:
        for loc_key, data in placed_pairs.items():
            tier_samples[f"gpu_net:{loc_key}"] = data
    for tier_name, data in tier_samples.items():
        tier = tiers[tier_name]
        for s, t in zip(*_samples(data)):
            obs_drift.record(
                name, tier_name, f"fit:{tier_name}", float(s),
                float(tier.time(float(s))), float(t),
            )
    paths = gpu_family_paths()
    strategies = gpu_family_strategies()
    variants = gpu_plan_variants()
    if not staged_family:
        paths = {"gpudirect": paths["gpudirect"]}
        strategies = {"cuda_aware": strategies["cuda_aware"]}
        variants = {"gpudirect": variants["gpudirect"]}
    spec = MachineSpec(
        name=name,
        tiers=tiers,
        paths=paths,
        strategies=strategies,
        plan_variants=variants,
        facts={
            "gpus_per_node": injectors_per_node,
            "cpu_cores_per_node": injectors_per_node * lanes_per_injector,
            "cores_per_gpu": lanes_per_injector,
            "injectors_per_node": injectors_per_node,
        },
        crossover_paths=("gpudirect", "three_step") if staged_family
        else ("gpudirect", "gpudirect"),
        description=f"fitted from measurements ({len(_samples(direct_net)[0])} "
                    f"direct-net samples)",
        provenance="fitted",
    )
    if register:
        register_machine(name, spec)
    return spec
