"""The published weights in the layout the program's loader takes.

``adapters/<family>.py`` has ``to_program(weights) -> variables``: the
reference family's published tensors as the nested numpy tree that
``imageclust_tpu_torch.models.create_embedder(..., variables=...)``
loads (the Flax layout: convolution kernels HWIO, dense kernels (in,
out), norm ``scale``/``bias``, BatchNorm statistics under
``batch_stats``). A transpose and a renaming only: what the program
derives from them (the space-to-depth stem, casts, int8 grids) it derives
itself.
"""
