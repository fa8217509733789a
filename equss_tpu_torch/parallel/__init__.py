from equss_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    replicate,
)
