from imageclust_tpu_torch.models.registry import (
    Embedder,
    EmbedderSpec,
    create_embedder,
    list_models,
)

__all__ = ["Embedder", "EmbedderSpec", "create_embedder", "list_models"]
