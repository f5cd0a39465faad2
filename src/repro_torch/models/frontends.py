"""Modality frontends: stubs, as in the reference.

PyTorch counterpart of ``repro.models.frontends``.  The whisper (audio)
and InternVL2 (vision) configs specify the transformer backbone only;
callers pass precomputed frame or patch embeddings of width ``d_model``,
and the frontend is one learned projection into ``d_model``.  The real
conv and ViT towers are out of scope in both packages.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import init_dense


def init_frontend(cfg, *, generator: torch.Generator, device,
                  dtype=torch.bfloat16) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    if cfg.frontend == "vision":
        return {"vision_proj": init_dense(cfg.d_model, cfg.d_model, **kw)}
    if cfg.frontend == "audio":
        return {"audio_proj": init_dense(cfg.d_model, cfg.d_model, **kw)}
    return {}


def audio_frames_to_embeddings(params: dict,
                               frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_len, d_model) precomputed log-mel + conv
    embeddings."""
    return frames @ params["audio_proj"]


def vision_patches_to_embeddings(params: dict,
                                 patches: torch.Tensor) -> torch.Tensor:
    """patches: (B, prefix_tokens, d_model) precomputed ViT patch
    embeddings."""
    return patches @ params["vision_proj"]
