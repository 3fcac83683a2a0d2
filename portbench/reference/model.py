"""A plain dense decoder in PyTorch: the reference the benchmark holds the
program's model to.

The architecture of the configurations in ``configs/`` (RMSNorm,
multi-head attention with rotary embeddings over the two halves of each
head, a SwiGLU MLP, tied or separate unembedding), written from the
equations with ``torch`` operations only: no kernel, cache or batching of
the program, and no import of it.  Every leaf carries a leading lane axis,
so one call computes the independent losses of A lanes (workers), each on
its own weights and tokens; the gradient of their sum by each lane's
weights is that lane's own gradient.

Products go through :class:`Matmul`, which computes them in the compute
dtype (float64 or float32, TF32 off) or, for the control runs, with the
operands rounded to TF32 or to scaled fp8 first.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

FP8_MAX = 448.0      # largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even), as
    float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled by its largest magnitude onto float8_e4m3fn, rounded there
    and scaled back, as float32 (per-tensor scaled fp8)."""
    x = x.to(torch.float32)
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _RoundedEinsum(torch.autograd.Function):
    """``einsum`` of the rounded operands, summed in float32; its backward
    products take the rounded cotangent and the rounded operands, as a
    lower-precision training step computes both passes."""

    @staticmethod
    def forward(ctx, eq, rnd, a, b):
        ar, br = rnd(a), rnd(b)
        ctx.save_for_backward(ar, br)
        ctx.eq, ctx.rnd = eq, rnd
        return torch.einsum(eq, ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        with torch.enable_grad():
            a = ar.detach().requires_grad_()
            b = br.detach().requires_grad_()
            out = torch.einsum(ctx.eq, a, b)
        ga, gb = torch.autograd.grad(out, (a, b), ctx.rnd(g))
        return None, None, ga, gb


class Matmul:
    """``einsum`` of two operands in ``dtype``, or with both operands (and,
    in the backward pass, the cotangent) rounded to ``precision`` ("tf32",
    "fp8") and summed in float32."""

    ROUND = {"tf32": round_tf32, "fp8": round_fp8}

    def __init__(self, dtype: torch.dtype, precision: Optional[str] = None):
        # float32 products in float32 on the card, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.round = self.ROUND[precision] if precision else None

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.round is None:
            return torch.einsum(eq, a.to(self.dtype), b.to(self.dtype))
        return _RoundedEinsum.apply(eq, self.round, a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) · scale over the last axis; scale (A, d) per lane."""
    y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return y * scale.to(x.dtype).reshape(
        scale.shape[:1] + (1,) * (x.dim() - 2) + scale.shape[-1:])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (A, B, T, H, dh) at positions 0..T-1: the
    first half of each head rotated against the second."""
    T, dh = x.shape[2], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=x.dtype,
                                         device=x.device) / dh)
    ang = torch.arange(T, dtype=x.dtype, device=x.device)[:, None] * freqs
    cos = torch.cos(ang)[None, None, :, None, :]
    sin = torch.sin(ang)[None, None, :, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, mm: Matmul, q_block: int) -> torch.Tensor:
    """Causal softmax attention of (A, B, T, H, dh) heads, one block of
    ``q_block`` queries at a time against the keys it can see."""
    T, dh = q.shape[2], q.shape[-1]
    outs = []
    for a in range(0, T, q_block):
        e = min(T, a + q_block)
        s = mm("abthd,abshd->abhts", q[:, :, a:e], k[:, :, :e]) / math.sqrt(dh)
        pos_q = torch.arange(a, e, device=q.device)[:, None]
        pos_k = torch.arange(e, device=q.device)[None, :]
        s = s.masked_fill(pos_k > pos_q, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(mm("abhts,abshd->abthd", p, v[:, :, :e]))
    return torch.cat(outs, dim=2)


def _layer(x, w: Dict[str, torch.Tensor], cfg: dict, mm: Matmul,
           q_block: int) -> torch.Tensor:
    A, B, T, d = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rmsnorm(x, w["ln1.scale"], eps)
    q = mm("abtd,adh->abth", h, w["attn.wq"]).reshape(A, B, T, H, dh)
    k = mm("abtd,adh->abth", h, w["attn.wk"]).reshape(A, B, T, KV, dh)
    v = mm("abtd,adh->abth", h, w["attn.wv"]).reshape(A, B, T, KV, dh)
    q, k = rope(q, theta), rope(k, theta)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=3)
        v = v.repeat_interleave(H // KV, dim=3)
    o = attention(q, k, v, mm, q_block).reshape(A, B, T, H * dh)
    x = x + mm("abth,ahd->abtd", o, w["attn.wo"])
    h = rmsnorm(x, w["ln2.scale"], eps)
    g = F.silu(mm("abtd,adf->abtf", h, w["ffn.w_gate"]))
    u = mm("abtd,adf->abtf", h, w["ffn.w_up"])
    return x + mm("abtf,afd->abtd", g * u, w["ffn.w_down"])


def lane_losses(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                cfg: dict, mm: Matmul, *, remat: bool = False,
                q_block: int = 512, ce_chunk: int = 512) -> torch.Tensor:
    """(A,) mean next-token cross-entropy of each lane.

    params: the program's leaf names, each with a leading lane axis (A, ...)
    (layer-stacked leaves (A, L, ...)); tokens: (A, B, T).  Hidden state t
    predicts token t+1; the mean is over the B·(T−1) predictions.  The
    weights are cast to ``mm.dtype`` where they are read.  ``remat``
    recomputes each layer and each CE chunk of ``ce_chunk`` positions in
    the backward pass instead of keeping their intermediates (for long
    sequences)."""
    dt = mm.dtype
    A, B, T = tokens.shape
    # the tied table is read twice (lookup and head): one cast, so both
    # gradients sum in the compute dtype before the leaf's dtype
    table = params["embed.table"].to(dt)
    x = table[torch.arange(A, device=tokens.device)[:, None, None], tokens]
    # each stacked leaf split once: its gradient is one stack of the
    # layers' gradients
    per_layer = {k[len("layers."):]: v.unbind(1) for k, v in params.items()
                 if k.startswith("layers.")}
    for layer in range(cfg["num_hidden_layers"]):
        w = {k: v[layer] for k, v in per_layer.items()}
        fn = lambda x, w=w: _layer(x, w, cfg, mm, q_block)  # noqa: E731
        x = ckpt.checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = rmsnorm(x, params["final_norm.scale"], cfg["rms_norm_eps"])
    head = params.get("head.w")
    targets = tokens[:, :, 1:]

    def nll(xc, tc):
        if head is None:
            logits = mm("abtd,avd->abtv", xc, table)
        else:
            logits = mm("abtd,adv->abtv", xc, head)
        logp = torch.log_softmax(logits.to(dt), dim=-1)
        return -logp.gather(-1, tc[..., None])[..., 0].sum((1, 2))

    total = torch.zeros(A, dtype=dt, device=tokens.device)
    for a in range(0, T - 1, ce_chunk):
        xc, tc = x[:, :, a:min(T - 1, a + ce_chunk)], targets[:, :, a:a + ce_chunk]
        total = total + (ckpt.checkpoint(nll, xc, tc, use_reentrant=False)
                         if remat else nll(xc, tc))
    return total / (B * (T - 1))
