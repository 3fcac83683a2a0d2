"""Float32 oracles of the sparse_gossip kernels (mirror the reference's
``repro/kernels/sparse_gossip/ref.py``)."""
import torch


def sparse_gossip_ref(W: torch.Tensor, G: torch.Tensor, P_sub: torch.Tensor,
                      Q_sub: torch.Tensor, workers: torch.Tensor) -> torch.Tensor:
    """Compact active-set mix: out = P_subᵀ·W[workers] − Q_subᵀ·G.

    ``workers`` may carry ``-1`` padding: padded lanes are clamped to row 0
    and must come with all-zero P_sub/Q_sub rows and columns.
    """
    f32 = torch.float32
    idx = workers.long().clamp(0, W.shape[0] - 1)
    Wa = W.index_select(0, idx).to(f32)
    out = (torch.einsum("ad,ab->bd", Wa, P_sub.to(f32))
           - torch.einsum("ad,ab->bd", G.to(f32), Q_sub.to(f32)))
    return out.to(W.dtype)


def sparse_scatter_rows_ref(X: torch.Tensor, rows: torch.Tensor,
                            workers: torch.Tensor) -> torch.Tensor:
    """Out-of-place scatter: valid lanes replace their row of X, lanes
    outside [0, N) (the ``-1`` padding) drop, every other row is kept."""
    out = X.clone()
    valid = (workers >= 0) & (workers < X.shape[0])
    out[workers[valid].long()] = rows[valid].to(X.dtype)
    return out


def sparse_gossip_apply_ref(W: torch.Tensor, G: torch.Tensor,
                            P_sub: torch.Tensor, scaled_mask: torch.Tensor,
                            workers: torch.Tensor) -> torch.Tensor:
    """Full-state oracle: gather → mix → scatter, identity off the active set."""
    f32 = torch.float32
    Q_sub = scaled_mask.to(f32)[:, None] * P_sub.to(f32)
    rows = sparse_gossip_ref(W, G, P_sub, Q_sub, workers)
    return sparse_scatter_rows_ref(W, rows, workers)
