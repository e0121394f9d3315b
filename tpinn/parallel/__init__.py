"""tpinn.parallel — device-mesh sharding for PINN training."""

from tpinn.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_multihost_mesh,
    round_count,
    points_sharding,
    replicated,
    shard_data,
    sharded_sampler,
    make_parallel_loss,
    ensemble_init,
    make_ensemble_loss,
)
