from ..core.mesh import (
    make_mesh,
    data_sharding,
    replicated,
    DATA_AXIS,
    MODEL_AXIS,
)
from .sharding import (
    shard_batch,
    all_reduce_mean,
    pmean_gradients,
    cross_replica_psum,
)
