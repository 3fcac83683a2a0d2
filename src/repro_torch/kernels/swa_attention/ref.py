"""Float32 oracle of sliding-window causal attention (mirrors the
reference's ``repro/kernels/swa_attention/ref.py:swa_attention_ref``)."""
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
