from clip_glass_torch.parallel import distributed  # noqa: F401
from clip_glass_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_rows,
    make_mesh,
    population_sharding,
    replicated_sharding,
    shard_state,
)
