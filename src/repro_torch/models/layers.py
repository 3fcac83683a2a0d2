"""Shared model primitives (the port of ``repro/models/layers.py``).

Conventions, as in the reference:
  * weights keep the reference's (in, out) layout and layers compute
    ``x @ w``, so a weight carries over from the JAX pytree untransposed;
    each weight is an ``nn.Module`` attribute named as the pytree key, so
    ``state_dict`` keys are the pytree paths (``layers.2.attn.wq``); a
    homogeneous stack keeps the reference's layer-stacked layout, every
    leaf with a leading layer axis (``lead``);
  * activations (B, T, D); attention heads (B, T, H, dh);
  * ``x @ w`` accumulates in float32 and returns the operands' dtype, as
    the reference's ``matmul`` (bf16 cuBLAS products reduce in float32 and
    TF32 is off, both set in ``repro_torch/__init__.py``);
  * ``init`` draws from an explicit ``torch.Generator``; with no generator
    the weights are left uninitialised for a load.

The layer functions read weights as attributes (``p.wq``, ``p.scale``), so
they run on the modules or on any object that exposes the same names (the
dense family's per-layer views of a flat parameter dict).

Prefill attention goes through the ``swa_attention`` kernel wrapper (the
reference's ``_plain_attention`` and ``blockwise_attention`` compute the
same causal, windowed function).  A caller that differentiates through
attention -- ``lm_loss``, as the reference's training forward, which never
reaches its Pallas kernel -- asks for ``_plain_attention`` with
``plain=True``.  Single-token decode against the rolling cache is plain
PyTorch, as in the reference.  The reference's ``_SHARD_HINT`` is a TPU
mesh hook for XLA's sharding propagation and is not ported, nor are (B, T)
positions, which no ported family uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.swa_attention import swa_attention


def weight(shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device,
           gen: Optional[torch.Generator], scale: Optional[float] = None,
           lead: Tuple[int, ...] = (), sliced: bool = False) -> nn.Parameter:
    """``lead + shape`` of N(0, scale²) drawn in float32 from ``gen`` (scale
    1/√fan_in of the per-layer ``shape`` by default, as the reference's
    ``_dense_init``), cast to ``dtype``; uninitialised when ``gen`` is
    None.  ``sliced`` draws one slice of ``shape[1:]`` at a time along the
    leading axes (``lead`` and ``shape[0]``) straight into the ``dtype``
    parameter, so no float32 copy of the whole leaf exists (an MoE
    layer-stack's experts: arctic's (L, 128, 7168, 4864) would need 35.7 GB
    of float32 per leaf at two layers)."""
    full = tuple(lead) + tuple(shape)
    if gen is None:
        w = torch.empty(full, dtype=dtype, device=device)
    else:
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        if sliced:
            w = torch.empty(full, dtype=dtype, device=device)
            for part in w.view(-1, *shape[1:]):
                part.copy_(torch.randn(shape[1:], generator=gen,
                                       device=gen.device).mul_(scale))
        else:
            w = torch.randn(full, generator=gen, device=gen.device).mul_(scale)
            w = w.to(device=device, dtype=dtype)
    return nn.Parameter(w, requires_grad=False)


def const(shape: Tuple[int, ...], value: float, dtype: torch.dtype,
          device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32`` without the cast back).  A bf16
    product on the card takes cuBLAS's float32 output directly; elsewhere
    the operands are widened to float32, which gives the same products."""
    if x.dtype == w.dtype == torch.bfloat16 and x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    return x.to(torch.float32) @ w.to(torch.float32)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (E, M, K) x (E, K, N) accumulated and returned in
    float32, as ``matmul_f32`` (the reference's
    ``einsum(..., preferred_element_type=float32)``)."""
    if a.dtype == b.dtype == torch.bfloat16 and a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device,
                 lead: Tuple[int, ...] = ()):
        super().__init__()
        self.scale = const(tuple(lead) + (d,), 1.0, dtype, device)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (halves of the head, not interleaved pairs)
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, dh); positions: (T,) absolute token positions."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = positions[:, None].to(torch.float32) * freqs[None, :]   # (T, dh/2)
    ang = ang[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, optional sliding window)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg, gen: Optional[torch.Generator],
                 device: torch.device, lead: Tuple[int, ...] = ()):
        super().__init__()
        d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        dt = cfg.pdtype
        self.wq = weight((d, H * dh), dt, device, gen, lead=lead)
        self.wk = weight((d, KV * dh), dt, device, gen, lead=lead)
        self.wv = weight((d, KV * dh), dt, device, gen, lead=lead)
        self.wo = weight((H * dh, d), dt, device, gen, lead=lead)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, dt, device, lead)
            self.k_norm = RMSNorm(dh, dt, device, lead)


def _plain_attention(q, k, v, positions_q, positions_k, window):
    """Materialised-scores attention, grouped (KV, G) so that k and v are
    read at their stored KV width: decode against the cache, and the
    differentiable training forward.  q: (B, Tq, H, dh); k, v:
    (B, Tk, KV, dh); positions (Tq,) and (Tk,), -1 marks an empty slot."""
    B, Tq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.reshape(B, Tq, KV, G, dh).to(f32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(f32)) / math.sqrt(dh)
    pq, pk = positions_q[:, None], positions_k[None, :]
    mask = (pk <= pq) & (pk >= 0)                    # causal + slot validity
    if window is not None:
        mask = mask & (pk > pq - window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(f32), v.to(f32))
    return out.reshape(B, Tq, H, dh).to(q.dtype)


@dataclasses.dataclass
class KVCache:
    """Rolling KV cache: ``size`` slots; absolute positions tracked per slot.

    Decode writes its token into the cache in place (the reference returns
    a new cache; the port saves the copy)."""
    k: torch.Tensor          # (B, size, KV, dh)
    v: torch.Tensor          # (B, size, KV, dh)
    positions: torch.Tensor  # (size,) int32 absolute position of each slot (-1 empty)

    @staticmethod
    def empty(batch: int, size: int, kv_heads: int, d_head: int,
              dtype: torch.dtype, device: torch.device) -> "KVCache":
        return KVCache(
            k=torch.zeros((batch, size, kv_heads, d_head), dtype=dtype,
                          device=device),
            v=torch.zeros((batch, size, kv_heads, d_head), dtype=dtype,
                          device=device),
            positions=torch.full((size,), -1, dtype=torch.int32, device=device),
        )


def build_cache_from_kv(k, v, positions, size: int) -> KVCache:
    """Rolling cache holding the last ``size`` positions of a prefilled k/v."""
    B, T, KV, dh = k.shape
    n = min(T, size)
    pos_tail = positions[T - n:].to(torch.int32)
    slots = (pos_tail % size).long()
    cache = KVCache.empty(B, size, KV, dh, k.dtype, k.device)
    cache.k[:, slots] = k[:, T - n:]
    cache.v[:, slots] = v[:, T - n:]
    cache.positions[slots] = pos_tail
    return cache


def apply_attention(p: Attention, cfg, x, positions, *,
                    cache: Optional[KVCache] = None,
                    window: Optional[int] = None,
                    build_cache: Optional[int] = None,
                    plain: bool = False):
    """Self-attention forward.

    Prefill: ``cache is None`` -- causal attention over the whole sequence
    through the ``swa_attention`` wrapper (exact for any run of consecutive
    positions), or through ``_plain_attention`` with ``plain=True`` (the
    differentiable training forward); with ``build_cache=size`` also
    returns a rolling KVCache of the last ``size`` positions.
    Decode: ``cache`` given and T == 1 -- writes the token at slot
    ``positions[0] % size`` (in place) and attends over the cache.
    Returns (out, cache).
    """
    B, T, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p.wq).reshape(B, T, H, dh)
    k = (x @ p.wk).reshape(B, T, KV, dh)
    v = (x @ p.wv).reshape(B, T, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if plain:
            out = _plain_attention(q, k, v, positions, positions, window)
        else:
            out = swa_attention(q, k, v, window=window)
        if build_cache is not None:
            cache = build_cache_from_kv(k, v, positions, build_cache)
    else:
        if T != 1:
            raise ValueError(f"the cache path is single-token decode, got T={T}")
        slot = (positions[:1] % cache.k.shape[1]).long()   # stays on the device
        cache.k.index_copy_(1, slot, k)
        cache.v.index_copy_(1, slot, v)
        cache.positions.index_copy_(0, slot, positions[:1].to(torch.int32))
        out = _plain_attention(q, cache.k, cache.v, positions[:1],
                               cache.positions, window)
    out = out.reshape(B, T, H * dh)
    return out @ p.wo, cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, f: int, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator],
                 lead: Tuple[int, ...] = ()):
        super().__init__()
        self.w_gate = weight((d, f), dtype, device, gen, lead=lead)
        self.w_up = weight((d, f), dtype, device, gen, lead=lead)
        self.w_down = weight((f, d), dtype, device, gen, lead=lead)


def apply_mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ p.w_gate).to(torch.float32)).to(x.dtype)
    return (g * (x @ p.w_up)) @ p.w_down


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        self.table = weight((vocab, d), dtype, device, gen, scale=0.02)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits, float32."""
    return matmul_f32(x, p.table.T)
