from repro_torch.runtime.straggler import EwmaZScore, StragglerMonitor, StragglerEvent
from repro_torch.runtime.fault import HostLost, InjectedFault
from repro_torch.runtime.elastic import shrink_and_replan
from repro_torch.runtime.scenarios import (
    Scenario,
    ScenarioEvent,
    ScenarioInjector,
    single_host_drop,
)

__all__ = [k for k in dir() if not k.startswith("_")]
