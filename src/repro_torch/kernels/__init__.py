"""Hand-written CUDA kernels of the port (sm_90a).

Each kernel package holds:

    csrc/*.cu   the CUDA C++ kernels, plain C launchers
    <name>.py   wrappers: checks, output allocation, launch, launch counts
    ops.py      public entry points (layouts, descriptors)
    ref.py      plain PyTorch versions the kernels are held against

``_build.py`` compiles each source with nvcc at first use.

Kernels:
    paged_attention  decode and ragged prefill+decode over the FPR paged
                     KV cache (block tables)
    mla_attention    absorbed-MLA paged decode over the latent pages
    mamba_scan       Mamba's selective scan (Jamba's mixer)
    rwkv6_scan       RWKV-6's WKV recurrence
    flash_attention  causal / sliding-window GQA attention over a full
                     sequence (``models.attention.attn_layer``)
"""
