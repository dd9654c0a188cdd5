"""AWS Rekognition labeler over signed HTTP.

Behavioral parity with internal/rekognition/rekognition.go:
* DetectLabels with MaxLabels / MinConfidence (rekognition.go:105-111),
* the 5 MB payload limit handled by iterative downscale — max dimension 2048
  first, then halve once more if still too large (rekognition.go:21,
  :174-260; the reference uses OpenCV INTER_LINEAR and a JPEG re-encode,
  reproduced here with cv2 — the same library),
* region default us-east-1 (workflow.go:44).

Transport is hand-signed SigV4 over the standard library
(utils/aws.py); caching is done by the CachedLabeler wrapper with
content-hash keys instead of the reference's collision-prone filename keys
(rekognition.go:127-131).

cv2 is imported only to shrink an image over the payload limit. Images
under it (the normal case at 5 MB) are sent as uploaded, so a machine
without cv2 labels them; an image over the limit there raises a
``ValueError`` that names cv2, and the labeling service retries and then
aborts the job, as it does on any labeling failure.
"""

from __future__ import annotations

import logging

from imageclust_tpu_torch.labels.base import Label
from imageclust_tpu_torch.utils.aws import AwsCredentials, aws_post_json

log = logging.getLogger(__name__)

__all__ = ["RekognitionLabeler", "shrink_to_payload_limit"]

_MAX_DIMENSION = 2048  # rekognition.go:201


def shrink_to_payload_limit(image_bytes: bytes, limit: int) -> bytes:
    """Downscale an over-limit image: resize so the larger side is 2048,
    re-encode JPEG; halve the dimensions once more if still too large
    (rekognition.go:174-260). Needs cv2 only for an image over ``limit``."""
    if len(image_bytes) <= limit:
        return image_bytes
    try:
        import cv2
    except ImportError as exc:
        raise ValueError(
            f"image of {len(image_bytes)} bytes is over the Rekognition "
            f"payload limit of {limit} bytes, and shrinking it needs cv2, "
            "which is not installed") from exc
    import numpy as np

    img = cv2.imdecode(np.frombuffer(image_bytes, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("failed to decode image for payload downscale")
    h, w = img.shape[:2]
    if w > h:
        new_w, new_h = _MAX_DIMENSION, int(_MAX_DIMENSION * h / w)
    else:
        new_h, new_w = _MAX_DIMENSION, int(_MAX_DIMENSION * w / h)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    ok, enc = cv2.imencode(".jpg", resized)
    if not ok:
        raise ValueError("failed to re-encode downscaled image")
    data = enc.tobytes()
    if len(data) > limit:
        resized = cv2.resize(img, (new_w // 2, new_h // 2),
                             interpolation=cv2.INTER_LINEAR)
        ok, enc = cv2.imencode(".jpg", resized)
        if not ok:
            raise ValueError("failed to re-encode downscaled image")
        data = enc.tobytes()
    log.info("downscaled image %d -> %d bytes for Rekognition",
             len(image_bytes), len(data))
    return data


class RekognitionLabeler:
    def __init__(
        self,
        region: str = "us-east-1",
        max_payload_bytes: int = 5 * 1024 * 1024,
        creds: AwsCredentials | None = None,
    ):
        self.region = region
        self.max_payload_bytes = max_payload_bytes
        self.creds = creds

    def detect_labels(
        self, image_bytes: bytes, max_labels: int, min_confidence: float
    ) -> list[Label]:
        import base64

        data = shrink_to_payload_limit(image_bytes, self.max_payload_bytes)
        payload = {
            "Image": {"Bytes": base64.b64encode(data).decode()},
            "MaxLabels": int(max_labels),
            "MinConfidence": float(min_confidence),
        }
        result = aws_post_json(
            f"https://rekognition.{self.region}.amazonaws.com/",
            region=self.region,
            service="rekognition",
            payload=payload,
            target="RekognitionService.DetectLabels",
            creds=self.creds,
        )
        return [
            Label(l["Name"], float(l.get("Confidence", 0.0)))
            for l in result.get("Labels", [])
        ]
