"""A request's prefill view and the table changes an engine makes between
prefills, shared by the CPU and on-card tests of the monolithic
prefill's CUDA graphs (no JAX here, so the on-card tests run where only
torch is installed)."""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.decode_graphs import POOLS

M = 8                # table columns: prompts up to 1024 tokens


def state(cfg, dtype, seed, device="cpu"):
    """The view ``Engine._prefill_request`` builds: pools (the config's:
    the fused KV pool, or the MLA latent and rope pools) of 3M blocks with
    random contents, the request's (1, M) table row on blocks [0, M),
    lengths 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    spec = tfm.cache_spec(cfg, 1, M * tfm.BLOCK_SIZE, 3 * M, dtype)
    st = {k: torch.randn(spec[k][0], generator=g, device=device).to(dtype)
          for k in POOLS if k in spec}
    st["tables"] = torch.arange(M, dtype=torch.int32, device=device)[None]
    st["lengths"] = torch.zeros(1, dtype=torch.int32, device=device)
    return st


def remap(st: dict, call: int) -> None:
    """Before prefill ``call``: one of the row's blocks recycled to a
    spare block and the last column a hole, in place, as the engine's
    allocator remaps a freed block."""
    tabs = st["tables"]
    N = next(st[k] for k in POOLS if k in st).shape[1]
    tabs[0, (call - 1) % (M - 1)] = N - call
    tabs[0, M - 1] = -1
