"""Shared data models — counterpart of internal/models/models.go."""

from __future__ import annotations

from dataclasses import dataclass, field

from imageclust_tpu_torch.naming.base import ModelOutput

__all__ = ["UploadedImage", "ClusterDetails"]


@dataclass
class UploadedImage:
    """models.go:10-13."""

    filename: str
    data: bytes


@dataclass
class ClusterDetails:
    """models.go:16-22: the per-cluster record the API and report render.

    ``title``/``catchy_phrase`` hold the primary service's output; the
    reference looked the primary up under the wrong name ("Claude 3",
    workflow.go:219-222) so its top-level fields stayed empty — here the
    first service in display order is the primary (documented fix)."""

    title: str = ""
    catchy_phrase: str = ""
    labels: str = ""
    images: list[str] = field(default_factory=list)
    service_outputs: list[ModelOutput] = field(default_factory=list)

    def get_output(self, service_name: str) -> ModelOutput | None:
        for out in self.service_outputs:  # models.go:32-39
            if out.service_name == service_name:
                return out
        return None

    def set_output(self, output: ModelOutput) -> None:
        for i, existing in enumerate(self.service_outputs):  # models.go:42-52
            if existing.service_name == output.service_name:
                self.service_outputs[i] = output
                return
        self.service_outputs.append(output)

    def to_dict(self) -> dict:
        return {
            "title": self.title,
            "catchyPhrase": self.catchy_phrase,
            "labels": self.labels,
            "images": list(self.images),
            "serviceOutputs": [
                {
                    "serviceName": o.service_name,
                    "title": o.title,
                    "catchyPhrase": o.catchy_phrase,
                }
                for o in self.service_outputs
            ],
        }
