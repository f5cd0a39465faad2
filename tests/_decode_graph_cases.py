"""A decode state and the table changes an engine makes between steps,
shared by the CPU and on-card tests of the decode step's piecewise
graphs (no JAX here, so the on-card tests run where only torch is
installed)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.decode_graphs import POOLS
from _torch_cases import shard_stack

M, W = 4, 2          # table columns (512 tokens), shards of the stack


def state(cfg, dtype, seed, B=4, device="cpu"):
    """Slot b on blocks [b*M, (b+1)*M) of pools (the config's: the fused
    KV pool, or the MLA latent and rope pools) with 8 spare blocks and
    random contents, lengths below 400 (slot 2 short), tables as the
    (W, B/W, M) stack."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    N = B * M + 8
    spec = tfm.cache_spec(cfg, B, M * tfm.BLOCK_SIZE, N, dtype)
    st = {k: torch.randn(spec[k][0], generator=g, device=device).to(dtype)
          for k in POOLS if k in spec}
    mono = np.arange(B * M, dtype=np.int32).reshape(B, M)
    lengths = rng.randint(100, 400, B).astype(np.int32)
    lengths[2] = 5
    st["tables"] = torch.from_numpy(shard_stack(mono, W)).to(device)
    st["lengths"] = torch.from_numpy(lengths).to(device)
    return st


def edit(st: dict, step: int) -> None:
    """Before ``step``: the engine's table changes, in place (as
    ``update_tables`` uploads a shard) or by a new stack (as a reshard
    makes one)."""
    tabs = st["tables"]
    N = next(st[k] for k in POOLS if k in st).shape[1]
    if step == 2:        # slot 3 frees its last block; slot 0 gets it
        tabs[3 % W, 3 // W, M - 1] = -1
        tabs[0 % W, 0 // W, 1] = 3 * M + M - 1
    elif step == 4:      # slot 2 restarts and is mid-prefill
        tabs[2 % W, 2 // W] = -1
        st["lengths"][2] = 0
    elif step == 6:      # a reallocated stack: slot 2 on spare blocks
        tabs = tabs.clone()
        tabs[2 % W, 2 // W] = torch.tensor([N - 2, N - 1, -1, -1])
        st["tables"] = tabs
        st["lengths"][2] = 100
