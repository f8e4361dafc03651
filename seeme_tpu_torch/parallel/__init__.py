from .mesh import (allreduce_metric_sums, batch_sharding, initialize_multihost, make_mesh,
                   replicated, shard_batch)
from .shardings import infer_param_shardings, shard_params
