"""Wrapper of the swa_attention CUDA kernel: sliding-window prefill attention.

``swa_attention`` keeps the reference's (B, T, H, dh) interface
(``repro/kernels/swa_attention/ops.py``): it flattens heads batch-major to
(B·H, T, dh) and (B·KV, T, dh), so the KV head of q head bh is
bh // (H // KV), and hands them to the kernel for CUDA tensors or to the
plain PyTorch version for CPU tensors -- nothing else.  The kernel masks
ragged T itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.swa_attention.ref import swa_attention_ref

_PROTOTYPES = {
    "swa_attention_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 4
    + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_void_p),
}
HEAD_DIMS = (64, 128, 256)   # head widths the kernel is instantiated for

# the plain version is the float32 oracle: materialised masked softmax
swa_attention_plain = swa_attention_ref


def swa_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, n_groups: int = 1) -> torch.Tensor:
    """The CUDA kernel: q (BH, T, dh), k and v (BH / n_groups, T, dh)."""
    dev = build.check_operands("swa_attention", {"q": q, "k": k, "v": v})
    if q.dim() != 3:
        raise ValueError(f"swa_attention: q must be (BH, T, dh), got {tuple(q.shape)}")
    BH, T, dh = q.shape
    if n_groups < 1 or BH % n_groups or k.shape != (BH // n_groups, T, dh) \
            or v.shape != k.shape:
        raise ValueError(
            f"swa_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not agree with n_groups={n_groups}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"swa_attention: head width {dh} is not one of "
                         f"{HEAD_DIMS}")
    if window < 1:
        raise ValueError(f"swa_attention: window must be >= 1, got {window}")
    if BH > 65535:
        raise ValueError(f"swa_attention: {BH} heads exceed the grid's 65535")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load("swa_attention", _PROTOTYPES)
    build.launch(
        lib, "swa_attention_launch", dev, build.DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, T, dh,
        n_groups, min(window, T), 1.0 / math.sqrt(dh))
    swa_attention_cuda.launches += 1
    return out


swa_attention_cuda.launches = 0


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int]) -> torch.Tensor:
    """Sliding-window causal self-attention over positions 0..T-1.

    q: (B, T, H, dh); k, v: (B, T, KV, dh) with H % KV == 0.  Returns
    (B, T, H, dh) in q's dtype.  ``window=None`` is plain causal attention.
    """
    B, T, H, dh = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"swa_attention: {H} heads are not a multiple of "
                         f"{KV} KV heads")
    window = T if window is None else window
    qf = q.transpose(1, 2).reshape(B * H, T, dh).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, T, dh).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, T, dh).contiguous()
    if q.device.type == "cpu":
        out = swa_attention_plain(qf, kf, vf, window=window, n_groups=H // KV)
    else:
        out = swa_attention_cuda(qf, kf, vf, window=window, n_groups=H // KV)
    return out.reshape(B, H, T, dh).transpose(1, 2)
