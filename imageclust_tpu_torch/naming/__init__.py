from imageclust_tpu_torch.naming.base import (
    FALLBACK_PHRASE,
    FALLBACK_TITLE,
    ModelOutput,
    truncate_and_sanitize,
)
from imageclust_tpu_torch.naming.registry import NamingService, create_naming_service

__all__ = [
    "FALLBACK_PHRASE",
    "FALLBACK_TITLE",
    "ModelOutput",
    "NamingService",
    "create_naming_service",
    "truncate_and_sanitize",
]
