"""repro_torch — the PyTorch/CUDA port of ``repro`` (split-network FL with
clustered data selection), for an NVIDIA H100.

It mirrors ``repro``'s layout (``configs/``, ``data/``, ``kernels/``,
``models/``, ``core/``, ``optim/``, ``fl/transport/``, ``obs/``) and imports
nothing of it, nor JAX. Entry points run on ``cuda`` unless the caller asks
for the CPU (``repro_torch.device.resolve_device``).
"""
