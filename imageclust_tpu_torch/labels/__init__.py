from imageclust_tpu_torch.labels.base import (
    CachedLabeler,
    Label,
    Labeler,
    create_labeler,
)
from imageclust_tpu_torch.labels.onehot import (
    build_label_set,
    combine_embeddings,
    label_vector,
    one_hot_matrix,
)
from imageclust_tpu_torch.labels.text_fusion import text_label_matrix

__all__ = [
    "CachedLabeler",
    "Label",
    "Labeler",
    "create_labeler",
    "build_label_set",
    "combine_embeddings",
    "label_vector",
    "one_hot_matrix",
    "text_label_matrix",
]
