from .mesh import make_mesh, AXIS
from .sharded_buckets import ShardedBucketedTopKSpMV
from .sharded_dense import ShardedDenseTopKSpMV
from .distributed import initialize_multihost, global_mesh

# Public multi-device engine = the bucketed layout (the only format).
ShardedTopKSpMV = ShardedBucketedTopKSpMV
