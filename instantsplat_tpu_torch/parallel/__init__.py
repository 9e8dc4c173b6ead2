from instantsplat_tpu_torch.parallel.runtime import (  # noqa: F401
    initialize_runtime,
    make_hybrid_mesh,
    make_mesh_nd,
)
from instantsplat_tpu_torch.parallel.tp import shard_params_tp  # noqa: F401
from instantsplat_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    gaussian_sharded_render,
    hybrid_sharded_render,
    make_sharded_train_step,
    sharded_render,
)
