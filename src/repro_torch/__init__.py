"""PyTorch/CUDA port of the FPR paged-KV serving system.

``repro`` (JAX, Pallas kernels for the TPU) is the reference; this package
mirrors its module names.  The host-side control plane (``core``,
``serving.admission``, ``serving.scheduler``, ``models.config``,
``configs``) is a verbatim copy of the reference's NumPy-only modules with
imports renamed; the device side (models, KV cache, engine) runs on torch
tensors, and the paged-attention kernels are CUDA C++ for sm_90a
(``kernels/paged_attention/csrc``), built with ``nvcc`` at first use.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.  Importing this package imports neither JAX nor ``repro``.
"""
