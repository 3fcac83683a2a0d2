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
reaches its Pallas kernel -- asks with ``plain=True`` for the reference's
own choice: ``blockwise_attention`` past T = 2·512 (each q block
rematerialised with ``remat=True``), ``_plain_attention`` below.  Past
2·512, inputs the training kernels take (bf16 CUDA tensors of head width
64 or 128, not under ``torch.func``) go to ``swa_attention_train`` instead,
the same function as one forward and one backward kernel
(``fused_attention_applies``); ``ATTENTION_ROUTES`` counts the calls of
each route.
Single-token decode against the rolling cache is plain PyTorch, as in the
reference.  The reference's ``_SHARD_HINT`` is a TPU mesh hook for XLA's
sharding propagation and is not ported, nor are (B, T) positions, which no
ported family uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels.swa_attention import (TRAIN_HEAD_DIMS, swa_attention,
                                               swa_attention_train)

# calls of the differentiable forward's attention by route, since the
# process started: ``swa_attention_train``, ``blockwise_attention``,
# ``_plain_attention`` (the training step adds each ``lm_loss``'s to its
# ``train.forward`` span)
ATTENTION_ROUTES = {"attn_fused": 0, "attn_blockwise": 0, "attn_plain": 0}


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


class _ProductF32(torch.autograd.Function):
    """a @ b of bf16 operands on the card, float32 out (cuBLAS's
    ``out_dtype``: bf16 products summed in float32, never rounded to bf16),
    for 2-D (``mm``) or batched 3-D (``bmm``) operands.  PyTorch has no
    derivative for ``out_dtype``, so the backward is written here, as the
    reference's transpose rule computes it: the float32 cotangent times
    the other bf16 operand, summed in float32 and rounded once to the
    operand's bf16.  The cotangent enters the tensor cores split into two
    bf16 parts (hi + lo, 16 of its 24 bits), so the product is float32-
    accurate where a single bf16 rounding of it would not be."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        hi = g.to(a.dtype)
        lo = (g - hi.to(g.dtype)).to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.transpose(-1, -2)
            da = (_product(hi, bt) + _product(lo, bt)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.transpose(-1, -2)
            db = (_product(at, hi) + _product(at, lo)).to(b.dtype)
        return da, db


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ b (2-D or batched) with cuBLAS's float32 output."""
    op = torch.mm if a.dim() == 2 else torch.bmm
    return op(a, b, out_dtype=torch.float32)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_product``, through ``_ProductF32`` only where autograd records
    it (an operand requires grad), so serving pays no autograd node."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ProductF32.apply(a, b)
    return _product(a, b)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32`` without the cast back).  A bf16
    product on the card takes cuBLAS's float32 output directly
    (``_product_f32``, differentiable); elsewhere the operands are widened
    to float32, which gives the same products."""
    if x.dtype == w.dtype == torch.bfloat16 and x.is_cuda:
        return _product_f32(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], -1)
    return x.to(torch.float32) @ w.to(torch.float32)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (E, M, K) x (E, K, N) accumulated and returned in
    float32, as ``matmul_f32`` (the reference's
    ``einsum(..., preferred_element_type=float32)``)."""
    if a.dtype == b.dtype == torch.bfloat16 and a.is_cuda:
        return _product_f32(a, b)
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


def rematerialise(fn, *args):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint``: the
    backward recomputes ``fn``'s intermediates instead of keeping them (the
    reference's ``jax.checkpoint``).  Reentrant checkpoint would drop the
    gradients of weights that ``fn`` reads through closures, so it is never
    used.  ``torch.func`` transforms cannot carry checkpoint's saved-tensor
    hooks: a rematerialised function is differentiated with
    ``torch.autograd.grad``."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _scores(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """(B, H, bq, bk) float32 scores of (B, bq, H, dh) and (B, bk, H, dh)
    blocks (``bmm_f32``: bf16 products summed in float32 on the card, as
    the reference's ``preferred_element_type``)."""
    B, bq, H, dh = qb.shape
    q = qb.transpose(1, 2).reshape(B * H, bq, dh)
    k = kb.permute(0, 2, 3, 1).reshape(B * H, dh, -1)
    return bmm_f32(q, k).view(B, H, bq, -1)


def blockwise_attention(q, k, v, *, window: Optional[int] = None,
                        block_q: int = 512, block_k: int = 512,
                        remat: bool = False):
    """Flash-style causal self-attention in plain PyTorch, differentiable
    (the reference's ``blockwise_attention``, its training path past T =
    2·block): never materialises the (T, T) scores.

    T is padded to a block multiple (padded keys sit at future positions
    the causal mask drops; padded query rows are cut at the end).  Each q
    block visits only the k blocks it can see -- up to the causal frontier
    in ascending order, or, with a window, the band of
    ``1 + ceil((window + block_q − 1) / block_k)`` blocks from the diagonal
    down, as the reference's scans visit them -- with the online softmax in
    float32 (masked scores −1e30, the sum floored at 1e-30).  With
    ``remat`` each q block runs under ``rematerialise`` (the reference
    always checkpoints it), so the backward recomputes its scores instead
    of keeping O(T²) of them; without it the values are the same and the
    function stays differentiable by ``torch.func``.  GQA repeats each k/v
    block to the H heads.
    q: (B, T, H, dh); k, v: (B, T, KV, dh).
    """
    B, T0, H, dh = q.shape
    G = H // k.shape[2]
    lcm = math.lcm(block_q, block_k)
    T = -(-T0 // lcm) * lcm
    if T != T0:
        pad = (0, 0, 0, 0, 0, T - T0)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    scale = 1.0 / math.sqrt(dh)
    n_band = (None if window is None
              else 1 + math.ceil((window + block_q - 1) / block_k))
    f32 = torch.float32

    def q_block(qi: int, qb: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        pos_q = qi * block_q + torch.arange(block_q, device=q.device)
        hi = (qi * block_q + block_q - 1) // block_k      # diagonal block
        kjs = (range(hi + 1) if n_band is None
               else [hi - off for off in range(n_band) if hi - off >= 0])
        acc = m = l = None
        for kj in kjs:
            kb = k[:, kj * block_k:(kj + 1) * block_k].repeat_interleave(G, 2)
            vb = v[:, kj * block_k:(kj + 1) * block_k].repeat_interleave(G, 2)
            pos_k = kj * block_k + torch.arange(block_k, device=q.device)
            s = _scores(qb, kb) * scale
            mask = pos_k[None, :] <= pos_q[:, None]
            if window is not None:
                mask = mask & (pos_k[None, :] > pos_q[:, None] - window)
            s = s.masked_fill(~mask, -1e30)
            if m is None:    # the reference's carries: acc 0, m −1e30, l 0
                m = torch.full(s.shape[:-1], -1e30, dtype=f32, device=s.device)
                l = s.new_zeros(s.shape[:-1])
                acc = s.new_zeros(s.shape[:-1] + (dh,))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vb.transpose(1, 2).to(f32)
            m = m_new
        return acc / torch.clamp(l[..., None], min=1e-30)   # (B, H, bq, dh)

    run = (lambda *a: rematerialise(q_block, *a)) if remat else q_block
    outs = [run(qi, q[:, qi * block_q:(qi + 1) * block_q], k, v)
            for qi in range(T // block_q)]
    out = torch.cat(outs, dim=2).transpose(1, 2)           # (B, T, H, dh)
    return out[:, :T0].to(q.dtype)


def fused_attention_applies(q: torch.Tensor) -> bool:
    """Whether the training forward's attention of ``q`` (B, T, H, dh) past
    T = 2·block goes to ``swa_attention_train``'s kernels: a bf16 CUDA
    tensor of a head width they take, not a ``torch.func`` wrapper (the
    simulator's ``vmap(grad)``, which an autograd.Function's kernels cannot
    see through).  Everything else -- float32, the CPU, dh 256, torch.func
    -- keeps ``blockwise_attention``."""
    return (not torch._C._functorch.is_functorch_wrapped_tensor(q)
            and q.is_cuda and q.dtype == torch.bfloat16
            and q.shape[-1] in TRAIN_HEAD_DIMS)


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
                    plain: bool = False, block_size: int = 512,
                    remat: bool = False):
    """Self-attention forward.

    Prefill: ``cache is None`` -- causal attention over the whole sequence
    through the ``swa_attention`` wrapper (exact for any run of consecutive
    positions), or, with ``plain=True`` (the differentiable training
    forward), as the reference computes it: ``blockwise_attention`` when
    T > 2·block_size (its q blocks rematerialised with ``remat``), else
    ``_plain_attention``, and past 2·block_size inputs the training
    kernels take (``fused_attention_applies``) go to
    ``swa_attention_train``, which keeps no checkpoint of its own; with
    ``build_cache=size`` also returns a rolling KVCache of the last
    ``size`` positions.
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
        if plain and T > 2 * block_size and fused_attention_applies(q):
            ATTENTION_ROUTES["attn_fused"] += 1
            out = swa_attention_train(q, k, v, window=window)
        elif plain and T > 2 * block_size:
            ATTENTION_ROUTES["attn_blockwise"] += 1
            out = blockwise_attention(q, k, v, window=window,
                                      block_q=block_size, block_k=block_size,
                                      remat=remat)
        elif plain:
            ATTENTION_ROUTES["attn_plain"] += 1
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
