"""Float32 oracle of the masked_gossip kernel (mirrors the reference's
``repro/kernels/gossip_mix/ref.py:masked_gossip_ref``)."""
import torch


def masked_gossip_ref(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                      scaled_mask: torch.Tensor) -> torch.Tensor:
    """out = Pᵀ · (W − diag(scaled_mask) · G) with scaled_mask = η·grad_mask."""
    f32 = torch.float32
    stepped = W.to(f32) - scaled_mask.to(f32)[:, None] * G.to(f32)
    return torch.einsum("nd,nj->jd", stepped, P.to(f32)).to(W.dtype)
