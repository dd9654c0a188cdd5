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
]
