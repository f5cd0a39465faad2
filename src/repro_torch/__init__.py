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

from repro_torch.configs import _MODULE_OF as _ARCH_MODULES  # noqa: E402

# Archs the port alone has: ``configs.get_config`` and ``get_smoke``
# resolve them, but they stay out of ``configs.ARCH_IDS``, which (like the
# rest of ``configs/__init__.py``, a verbatim copy of the reference's) lists
# the archs the tests pair with the reference's configs and dry runs.
_ARCH_MODULES["deepseek-v3-671b"] = "repro_torch.configs.deepseek_v3_671b"
