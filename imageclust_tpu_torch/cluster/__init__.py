from imageclust_tpu_torch.cluster.chain import constrained_ward_chain
from imageclust_tpu_torch.cluster.sharded import constrained_ward_bucketed
from imageclust_tpu_torch.cluster.ward import (
    ClusterResult,
    ConstraintError,
    calculate_optimal_clusters,
    constrained_ward,
)

__all__ = [
    "ClusterResult",
    "ConstraintError",
    "calculate_optimal_clusters",
    "constrained_ward",
    "constrained_ward_bucketed",
    "constrained_ward_chain",
]
