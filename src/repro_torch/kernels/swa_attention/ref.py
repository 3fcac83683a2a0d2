"""Float32 oracle of sliding-window causal attention (mirrors the
reference's ``repro/kernels/swa_attention/ref.py:swa_attention_ref``), and
the plain versions of the training attention's forward and backward
kernels (the arithmetic of ``csrc/swa_attention.cu``'s training variant
and of ``csrc/swa_attention_bwd.cu``)."""
import math

import torch


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int, n_groups: int = 1) -> torch.Tensor:
    """q: (BH, T, dh); k, v: (BKV, T, dh), BH = BKV · n_groups.

    Materialises the (BH, T, T) scores in float32; returns q's dtype.
    """
    BH, T, dh = q.shape
    kf = torch.repeat_interleave(k.to(torch.float32), n_groups, dim=0)
    vf = torch.repeat_interleave(v.to(torch.float32), n_groups, dim=0)
    s = torch.einsum("htd,hsd->hts", q.to(torch.float32), kf) / math.sqrt(dh)
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hts,hsd->htd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# the training attention: forward with the log-sum-exp, and its backward
# ---------------------------------------------------------------------------

def _hi_lo(x: torch.Tensor):
    """float32 x as two bf16-exact float32 parts, hi = bf16(x) and lo =
    bf16(x − hi): what the kernels hand the tensor cores for an operand the
    blockwise path holds in float32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _split_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y with x entering as hi + lo, summed in float32."""
    hi, lo = _hi_lo(x)
    return hi @ y + lo @ y


def _band(T: int, window: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


def _groups(q, k, v):
    """Per KV head j: (q heads of j, k, v), each (B, G or 1, T, dh)
    float32, and the slice of q's heads."""
    B, T, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    f32 = torch.float32
    for j in range(KV):
        heads = slice(j * G, (j + 1) * G)
        yield (heads, q[:, :, heads].to(f32).transpose(1, 2),
               k[:, :, j:j + 1].to(f32).transpose(1, 2),
               v[:, :, j:j + 1].to(f32).transpose(1, 2))


def swa_attention_train_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int):
    """The training forward's arithmetic, materialised one KV head at a
    time: q (B, T, H, dh), k and v (B, T, KV, dh).  Scores in float32 (the
    products of q's and k's values), masked −1e30, softmax against the
    row's max with the sum floored at 1e-30, P entering P·V as hi + lo.
    Returns (out in q's dtype (B, T, H, dh), lse (B, H, T) float32, the
    natural log-sum-exp m + log l)."""
    B, T, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    band = _band(T, window, q.device)
    out = torch.empty(B, H, T, dh, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    for heads, qg, kg, vg in _groups(q, k, v):
        s = (qg @ kg.transpose(-1, -2) * scale).masked_fill(~band, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        out[:, heads] = _split_product(p, vg) / l
        lse[:, heads] = (m + torch.log(l))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def swa_attention_train_bwd_ref(q, k, v, out, lse, dout, *, window: int):
    """The backward's arithmetic from the forward's output and log-sum-exp:
    D = rowsum(dout ∘ out), P = exp(S·scale − lse) (masked 0), dV = Pᵀ·dO,
    dS = P ∘ (dO·Vᵀ − D), dK = dSᵀ·Q·scale, dQ = dS·K·scale, P and dS
    entering their products as hi + lo; a KV head's dK and dV summed over
    its q heads.  Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, T, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    band = _band(T, window, q.device)
    f32 = torch.float32
    do = dout.to(f32).transpose(1, 2)                       # (B, H, T, dh)
    D = (do * out.to(f32).transpose(1, 2)).sum(dim=-1, keepdim=True)
    dq = torch.empty(B, H, T, dh, dtype=f32, device=q.device)
    dk = torch.empty(B, k.shape[2], T, dh, dtype=f32, device=q.device)
    dv = torch.empty_like(dk)
    for j, (heads, qg, kg, vg) in enumerate(_groups(q, k, v)):
        s = (qg @ kg.transpose(-1, -2) * scale).masked_fill(~band, -1e30)
        p = torch.exp(s - lse[:, heads, :, None])
        dog = do[:, heads]
        ds = p * (dog @ vg.transpose(-1, -2) - D[:, heads])
        dv[:, j] = _split_product(p.transpose(-1, -2), dog).sum(dim=1)
        dk[:, j] = _split_product(ds.transpose(-1, -2), qg).sum(dim=1) * scale
        dq[:, heads] = _split_product(ds, kg) * scale
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
