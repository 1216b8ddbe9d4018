from repro_torch.runtime.straggler import EwmaZScore, StragglerMonitor, StragglerEvent
from repro_torch.runtime.fault import (
    BackoffPolicy,
    HostLost,
    InjectedFault,
    LoopState,
    RecoveryExhausted,
    run_with_recovery,
)
from repro_torch.runtime.elastic import (
    host_drop_drill,
    reshard_tree,
    restore_on_mesh,
    shrink_and_replan,
)
from repro_torch.runtime.scenarios import (
    Scenario,
    ScenarioEvent,
    ScenarioInjector,
    single_host_drop,
)

__all__ = [k for k in dir() if not k.startswith("_")]
