from repro_torch.kernels.config import DEFAULT_DEVICE, kernels_enabled, use_kernels

__all__ = ["DEFAULT_DEVICE", "kernels_enabled", "use_kernels"]
