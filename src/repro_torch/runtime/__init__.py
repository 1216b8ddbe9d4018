from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
