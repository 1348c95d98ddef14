from clip_glass_torch.parallel import distributed  # noqa: F401
from clip_glass_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    abstract_mesh,
    gather_rows,
    make_mesh,
    population_sharding,
    replicated_sharding,
    shard_clip_tp,
    shard_state,
)
