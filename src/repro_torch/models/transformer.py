"""Decoder model of the port (``repro/models/transformer.py``), hybrid family.

RecurrentGemma's wiring, unrolled over the block pattern
("rec", "rec", "attn"):

    rec  : [RMSNorm → RG-LRU block → +] [RMSNorm → SwiGLU → +]
    attn : [RMSNorm → local attention → +] [RMSNorm → SwiGLU → +]

Three entry points share one layer runner:
  * ``forward``     — full-sequence logits (B, T, V)
  * ``prefill``     — full sequence; last-token logits (B, V) + decode state
  * ``decode_step`` — one token against the decode state

Decode state is a tuple with one entry per layer: ``RGLRUState`` for a
recurrent layer, a rolling ``KVCache`` for an attention layer.  The other
families (dense, moe, ssm, audio, vlm) and ``lm_loss`` are not ported yet
(ROADMAP A6); asking for them raises ``NotImplementedError``.  The weights
do not require gradients: nothing here is differentiable through the
kernels yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models.layers import KVCache


def _require_hybrid(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            "runs the hybrid family only (ROADMAP A6)")


def block_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg._pattern_expanded()


class AttnLayer(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.pdtype, device, gen)


class RecLayer(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.rec = RG.RGLRUBlock(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.pdtype, device, gen)


class Head(nn.Module):
    def __init__(self, cfg, gen, device):
        super().__init__()
        self.w = L.weight((cfg.d_model, cfg.vocab_size), cfg.pdtype, device,
                          gen, scale=0.02)


class LM(nn.Module):
    """The model's weights; ``state_dict`` keys are the reference's pytree
    paths (``embed.table``, ``layers.0.rec.w_in``, ``head.w``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        _require_hybrid(cfg)
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, cfg.pdtype,
                                 device, gen)
        kinds = {"attn": AttnLayer, "rec": RecLayer}
        self.layers = nn.ModuleList(kinds[pt](cfg, gen, device)
                                    for pt in block_pattern(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        if not cfg.tie_embeddings:
            self.head = Head(cfg, gen, device)


def init_model(cfg: ModelConfig, gen: Optional[torch.Generator],
               device: DeviceLike = "cuda") -> LM:
    """The model on ``device``, its weights drawn from ``gen`` with the
    reference's initialisers (uninitialised when ``gen`` is None, for a
    load).  The draws happen on ``gen``'s device."""
    return LM(cfg, resolve_device(device), gen)


# ---------------------------------------------------------------------------
# Layer runner
# ---------------------------------------------------------------------------

def _apply_attn_layer(p: AttnLayer, cfg, x, positions, state, window,
                      build_cache=None):
    h = L.rmsnorm(p.ln1, x, cfg.norm_eps)
    attn_out, new_state = L.apply_attention(
        p.attn, cfg, h, positions, cache=state, window=window,
        build_cache=build_cache)
    x = x + attn_out
    h = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + L.apply_mlp(p.ffn, h), new_state


def _apply_rec_layer(p: RecLayer, cfg, x, state):
    h = L.rmsnorm(p.ln1, x, cfg.norm_eps)
    rec_out, new_state = RG.apply_rglru_block(p.rec, cfg, h, state)
    x = x + rec_out
    h = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    return x + L.apply_mlp(p.ffn, h), new_state


def _run_layers(model: LM, cfg: ModelConfig, x, positions, *, states=None,
                build_cache: Optional[int] = None):
    """Run all blocks.  Returns (x, new_states_or_None).

    states given       → decode (per-layer state in/out)
    build_cache = size → prefill: construct decode states
    neither            → plain forward
    """
    _require_hybrid(cfg)
    window = cfg.attn_window
    collect = (states is not None) or (build_cache is not None)
    new_states = []
    for i, (pt, lp) in enumerate(zip(block_pattern(cfg), model.layers)):
        st = states[i] if states is not None else None
        if pt == "attn":
            bc = build_cache if states is None else None
            if bc is not None and window:
                bc = min(bc, window)
            x, st2 = _apply_attn_layer(lp, cfg, x, positions, st, window, bc)
        else:
            x, st2 = _apply_rec_layer(lp, cfg, x, st)
        new_states.append(st2)
    return x, (tuple(new_states) if collect else None)


def _logits(model: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits."""
    if cfg.tie_embeddings:
        return L.unembed(model.embed, x)
    return L.matmul_f32(x, model.head.w)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(model: LM, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, T) int.  Returns logits (B, T, V) in float32 (the
    hybrid family has no auxiliary loss)."""
    x = L.embed(model.embed, tokens).to(cfg.cdtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, _ = _run_layers(model, cfg, x, positions)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x)


def prefill(model: LM, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int):
    """Full-sequence prefill.  Returns (last-token logits (B, V), decode
    state); only the last position reaches the head."""
    x = L.embed(model.embed, tokens).to(cfg.cdtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, states = _run_layers(model, cfg, x, positions, build_cache=cache_len)
    x = L.rmsnorm(model.final_norm, x[:, -1:], cfg.norm_eps)
    return _logits(model, cfg, x)[:, 0], states


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = "cuda"):
    """Empty per-layer decode state sized for a KV history of ``cache_len``;
    the attention cache is ``min(window, cache_len)`` slots (rolling)."""
    _require_hybrid(cfg)
    dev = resolve_device(device)
    window = cfg.attn_window
    attn_len = min(window, cache_len) if window else cache_len
    dt = cfg.cdtype

    return tuple(
        KVCache.empty(batch, attn_len, cfg.n_kv_heads, cfg.d_head, dt, dev)
        if pt == "attn" else RG.RGLRUState.zeros(batch, cfg, dt, dev)
        for pt in block_pattern(cfg))


def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor, state,
                pos: int):
    """One decode step.  token: (B,); pos: the token's absolute position.

    Returns (logits (B, V) float32, new_state); the attention layers'
    caches are updated in place.
    """
    x = L.embed(model.embed, token[:, None]).to(cfg.cdtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, new_state = _run_layers(model, cfg, x, positions, states=state)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x)[:, 0], new_state
