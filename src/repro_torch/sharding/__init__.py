from repro_torch.sharding.specs import (
    PartitionSpec,
    Sharding,
    batch_sharding,
    cache_shardings,
    mesh_shape,
    opt_shardings,
    param_shardings,
    param_spec,
    tp_adapt,
)

__all__ = [k for k in dir() if not k.startswith("_")]
