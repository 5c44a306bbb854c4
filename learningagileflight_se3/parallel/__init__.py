from learningagileflight_se3.parallel.mesh import (
    make_mesh,
    shard_batch,
    replicate,
)
