"""Wrapper of the masked_gossip CUDA kernel: the dense event update.

``masked_gossip_mix`` is the op the dense scan calls once per leaf per
event: out = Pᵀ·(W − diag(η·mask)·G) for any (N, ...) leaf.  It flattens the
leaf to (N, D), folds the step into a second matrix Q = diag(η·mask)·P in
the leaf's dtype (as the reference's ops do), and hands (W, G, P, Q) to
``masked_gossip_update``, which launches the kernel for CUDA tensors and
runs the plain PyTorch version for CPU tensors -- nothing else.  The kernel
masks ragged N and D itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_PROTOTYPES = {
    "masked_gossip_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 5
    + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
}


def masked_gossip_plain(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                        Q: torch.Tensor) -> torch.Tensor:
    """out = Pᵀ·W − Qᵀ·G on (N, D) operands, in float32, cast to W's dtype."""
    f32 = torch.float32
    out = (torch.einsum("nd,nj->jd", W.to(f32), P.to(f32))
           - torch.einsum("nd,nj->jd", G.to(f32), Q.to(f32)))
    return out.to(W.dtype)


def masked_gossip_cuda(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                       Q: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: out = Pᵀ·W − Qᵀ·G, W/G (N, D), P/Q (N, N)."""
    dev = build.check_operands("masked_gossip",
                               {"W": W, "G": G, "P": P, "Q": Q})
    if W.dim() != 2:
        raise ValueError(f"masked_gossip: W must be (N, D), got {tuple(W.shape)}")
    N, D = W.shape
    if G.shape != W.shape or P.shape != (N, N) or Q.shape != (N, N):
        raise ValueError(
            f"masked_gossip: shapes W{tuple(W.shape)} G{tuple(G.shape)} "
            f"P{tuple(P.shape)} Q{tuple(Q.shape)} do not agree")
    out = torch.empty_like(W)
    if out.numel() == 0:
        return out
    lib = build.load("masked_gossip", _PROTOTYPES)
    with torch.cuda.device(dev):
        status = lib.masked_gossip_launch(
            build.DTYPE_CODES[W.dtype], W.data_ptr(), G.data_ptr(),
            P.data_ptr(), Q.data_ptr(), out.data_ptr(), N, D,
            build.stream_handle(dev))
    build.check_status(lib, status, "masked_gossip")
    masked_gossip_cuda.launches += 1
    return out


masked_gossip_cuda.launches = 0


def masked_gossip_update(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                         Q: torch.Tensor) -> torch.Tensor:
    """Pᵀ·W − Qᵀ·G: the plain version for CPU tensors, else the kernel."""
    if W.device.type == "cpu":
        return masked_gossip_plain(W, G, P, Q)
    return masked_gossip_cuda(W, G, P, Q)


def masked_gossip_mix(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                      scaled_mask: torch.Tensor) -> torch.Tensor:
    """Fused event update: out = Pᵀ·(W − diag(scaled_mask)·G), any (N, ...) W.

    ``scaled_mask`` is η·grad_mask (length N).  P and Q reach the kernel in
    W's dtype; the kernel accumulates in float32.
    """
    N = W.shape[0]
    flat_w = W.reshape(N, -1).contiguous()
    flat_g = G.reshape(N, -1).to(flat_w.dtype).contiguous()
    P = P.to(flat_w.dtype)
    Q = (scaled_mask.to(flat_w.dtype)[:, None] * P).contiguous()
    out = masked_gossip_update(flat_w, flat_g, P.contiguous(), Q)
    return out.reshape(W.shape)
