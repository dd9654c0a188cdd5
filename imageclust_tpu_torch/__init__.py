"""imageclust_tpu_torch — the PyTorch/CUDA port of imageclust_tpu.

The same pipeline (ingest -> label -> embed -> cluster -> name -> report)
and REST surface, running on an NVIDIA GPU through PyTorch, with the JAX
package's Pallas kernels rewritten by hand for Hopper (``csrc/``). The port
imports neither JAX nor anything of :mod:`imageclust_tpu`; it keeps its own
copies of the framework-free modules (config, types, labels, naming,
report, data).

Every entry point takes a ``device`` (default ``"cuda"``) and raises when
that device is absent: nothing falls back to the CPU unless asked to.
"""

__version__ = "0.1.0"

__all__ = ["__version__", "AppConfig", "Pipeline", "UploadedImage",
           "load_config", "resolve_device"]


def __getattr__(name):
    # lazy top-level API: importing the package does not import torch
    if name in ("AppConfig", "load_config"):
        from imageclust_tpu_torch import config

        return getattr(config, name)
    if name == "Pipeline":
        from imageclust_tpu_torch.pipeline import Pipeline

        return Pipeline
    if name == "UploadedImage":
        from imageclust_tpu_torch.types import UploadedImage

        return UploadedImage
    if name == "resolve_device":
        from imageclust_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(name)
