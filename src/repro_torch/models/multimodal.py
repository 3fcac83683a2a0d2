"""Stub modality frontends (the port of ``repro/models/multimodal.py``).

The ``audio`` and ``vlm`` architectures specify the transformer backbone
only; the mel-spectrogram/EnCodec conv stack and the ViT/SigLIP encoder +
projector are not implemented.  These helpers give the precomputed
frame/patch embeddings of the right shape, which ``forward``, ``lm_loss``
and ``prefill`` prepend to the token embeddings (``prefix_embeds``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def prefix_shape(cfg: ModelConfig, batch: int) -> Tuple[int, int, int]:
    """(B, P, D) shape of the stub frontend's output embeddings."""
    if cfg.frontend not in ("audio", "vision"):
        raise ValueError(f"{cfg.name} has no stub frontend (frontend="
                         f"{cfg.frontend!r})")
    return (batch, cfg.n_prefix_tokens, cfg.d_model)


def make_stub_prefix(gen: torch.Generator, cfg: ModelConfig, batch: int,
                     device: DeviceLike = "cuda",
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Random placeholder embeddings N(0, 0.02²) standing in for the frozen
    frontend, drawn in float32 on ``gen``'s device and cast to ``dtype``
    (the config's compute dtype by default) on ``device``."""
    dev = resolve_device(device)
    x = torch.randn(prefix_shape(cfg, batch), generator=gen, device=gen.device)
    return (x * 0.02).to(device=dev, dtype=dtype or cfg.cdtype)


def anyres_tile_count(image_hw, tile: int = 336, patches_per_tile: int = 576,
                      max_tiles: int = 4) -> int:
    """LLaVA-NeXT anyres tiling: #patches for an image (base tile + grid
    tiles).  The config pins the worst case (4 grid tiles + base = 2880)."""
    h, w = image_hw
    gh, gw = -(-h // tile), -(-w // tile)
    n_tiles = min(gh * gw, max_tiles) + 1      # +1 global base tile
    return n_tiles * patches_per_tile
