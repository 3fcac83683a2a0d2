"""Float32 oracles of the gossip_mix kernels (mirror the reference's
``repro/kernels/gossip_mix/ref.py``)."""
import torch


def gossip_mix_ref(W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """out[j, d] = Σ_i P[i, j] · W[i, d]  ==  Pᵀ @ W."""
    return torch.einsum("nd,nj->jd", W.to(torch.float32),
                        P.to(torch.float32)).to(W.dtype)


def masked_gossip_ref(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                      scaled_mask: torch.Tensor) -> torch.Tensor:
    """out = Pᵀ · (W − diag(scaled_mask) · G) with scaled_mask = η·grad_mask."""
    f32 = torch.float32
    stepped = W.to(f32) - scaled_mask.to(f32)[:, None] * G.to(f32)
    return torch.einsum("nd,nj->jd", stepped, P.to(f32)).to(W.dtype)


def gossip_mix_batched_ref(W: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """out[e] = P[e]ᵀ @ W[e] for stacked (E, N, D) problems."""
    return torch.einsum("end,enj->ejd", W.to(torch.float32),
                        P.to(torch.float32)).to(W.dtype)
