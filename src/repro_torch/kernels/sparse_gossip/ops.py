"""Wrappers of the sparse_gossip and scatter_rows CUDA kernels.

The gather-compute-scatter contract of the active-set update, per leaf:

- ``sparse_gossip_rows`` returns the compact (A, ...) mixed rows
  P_subᵀ·(W[workers] − η·mask⊙G) (gather and mix fused in the kernel);
- ``scatter_active_rows`` writes them into the (N, ...) carry **in place**
  (the port mutates the carry where the reference donated it): valid lanes
  overwrite their rows, ``-1`` lanes write nothing.

Padding contract (shared with the schedulers' ``SparseEventBatch``):
``workers`` is ``-1``-padded in any lane.  Before the kernel sees anything,
padded lanes are clamped to row 0 and their P_sub rows/columns and mask
entries are zeroed, so a padded lane neither contributes mass nor receives
any -- its compact row is exactly zero.  The kernels mask ragged A and D
themselves, so nothing is padded here.

Each ``*_cuda`` function launches its kernel and counts the launch; each
``*_plain`` function is the same function in plain PyTorch, taken only for
CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_GOSSIP_PROTOTYPES = {
    "sparse_gossip_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 6
    + (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
}
_SCATTER_PROTOTYPES = {
    "scatter_rows_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 3
    + (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
}


# -- compact mix ------------------------------------------------------------

def sparse_gossip_plain(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                        Q: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """out = Pᵀ·W[gidx] − Qᵀ·G in float32, cast to W's dtype.

    W (N, D), G (A, D), P/Q (A, A), gidx (A,) -- clamped into [0, N) like
    the kernel's gather.
    """
    f32 = torch.float32
    Wa = W.index_select(0, gidx.long().clamp(0, W.shape[0] - 1)).to(f32)
    out = (torch.einsum("ad,ab->bd", Wa, P.to(f32))
           - torch.einsum("ad,ab->bd", G.to(f32), Q.to(f32)))
    return out.to(W.dtype)


def sparse_gossip_cuda(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                       Q: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: compact rows out (A, D) = Pᵀ·W[gidx] − Qᵀ·G."""
    dev = build.check_operands("sparse_gossip",
                               {"W": W, "G": G, "P": P, "Q": Q},
                               {"gidx": gidx})
    if W.dim() != 2 or G.dim() != 2 or gidx.dim() != 1:
        raise ValueError("sparse_gossip: W and G must be 2-D, gidx 1-D")
    N, D = W.shape
    A = gidx.shape[0]
    if G.shape != (A, D) or P.shape != (A, A) or Q.shape != (A, A):
        raise ValueError(
            f"sparse_gossip: shapes W{tuple(W.shape)} G{tuple(G.shape)} "
            f"P{tuple(P.shape)} Q{tuple(Q.shape)} gidx{tuple(gidx.shape)} "
            "do not agree")
    if N == 0:
        raise ValueError("sparse_gossip: W has no rows to gather")
    out = torch.empty((A, D), dtype=W.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load("sparse_gossip", _GOSSIP_PROTOTYPES)
    with torch.cuda.device(dev):
        status = lib.sparse_gossip_launch(
            build.DTYPE_CODES[W.dtype], W.data_ptr(), G.data_ptr(),
            P.data_ptr(), Q.data_ptr(), gidx.data_ptr(), out.data_ptr(),
            N, A, D, build.stream_handle(dev))
    build.check_status(lib, status, "sparse_gossip")
    sparse_gossip_cuda.launches += 1
    return out


sparse_gossip_cuda.launches = 0


def sparse_gossip_compact(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                          Q: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Compact mix: the plain version for CPU tensors, else the kernel."""
    if W.device.type == "cpu":
        return sparse_gossip_plain(W, G, P, Q, gidx)
    return sparse_gossip_cuda(W, G, P, Q, gidx)


def sparse_gossip_rows(W: torch.Tensor, G: torch.Tensor, P_sub: torch.Tensor,
                       scaled_mask: torch.Tensor,
                       workers: torch.Tensor) -> torch.Tensor:
    """Compact active-set event update rows for one (N, ...) leaf.

    out[b] = Σ_a P_sub[a, b]·(W[workers[a]] − scaled_mask[a]·G[a]) for the
    valid lanes; zero rows for ``-1``-padded lanes.  W: (N, ...); G: (A, ...)
    active-set gradients; P_sub: (A, A); scaled_mask: (A,) = η·grad_mask.
    """
    N = W.shape[0]
    A = workers.shape[0]
    valid = workers >= 0
    gidx = torch.where(valid, workers, 0).to(torch.int32).contiguous()
    vf = valid.to(P_sub.dtype)
    P = P_sub * vf[:, None] * vf[None, :]
    Q = (scaled_mask * vf).to(P.dtype)[:, None] * P
    flat_w = W.reshape(N, -1).contiguous()
    flat_g = G.reshape(A, -1).to(flat_w.dtype).contiguous()
    out = sparse_gossip_compact(flat_w, flat_g,
                                P.to(flat_w.dtype).contiguous(),
                                Q.to(flat_w.dtype).contiguous(), gidx)
    return out.reshape((A,) + tuple(W.shape[1:]))


# -- in-place scatter -------------------------------------------------------

def scatter_rows_plain(X: torch.Tensor, rows: torch.Tensor,
                       workers: torch.Tensor) -> torch.Tensor:
    """X[workers[a]] = rows[a] for lanes in [0, N), in place; returns X."""
    valid = (workers >= 0) & (workers < X.shape[0])
    X[workers[valid].long()] = rows[valid].to(X.dtype)
    return X


def scatter_rows_cuda(X: torch.Tensor, rows: torch.Tensor,
                      workers: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: scatter rows (A, D) into X (N, D) in place."""
    dev = build.check_operands("scatter_rows", {"X": X, "rows": rows},
                               {"workers": workers})
    if X.dim() != 2 or workers.dim() != 1:
        raise ValueError("scatter_rows: X must be 2-D, workers 1-D")
    N, D = X.shape
    A = workers.shape[0]
    if rows.shape != (A, D):
        raise ValueError(f"scatter_rows: rows{tuple(rows.shape)} do not match "
                         f"(A, D) = {(A, D)}")
    if A == 0 or D == 0:
        return X
    lib = build.load("scatter_rows", _SCATTER_PROTOTYPES)
    with torch.cuda.device(dev):
        status = lib.scatter_rows_launch(
            build.DTYPE_CODES[X.dtype], X.data_ptr(), rows.data_ptr(),
            workers.data_ptr(), N, A, D, build.stream_handle(dev))
    build.check_status(lib, status, "scatter_rows")
    scatter_rows_cuda.launches += 1
    return X


scatter_rows_cuda.launches = 0


def scatter_active_rows(X: torch.Tensor, rows: torch.Tensor,
                        workers: torch.Tensor) -> torch.Tensor:
    """Scatter compact (A, ...) rows into the (N, ...) carry leaf, in place.

    ``X`` must be contiguous (the flat view aliases it).  Valid lanes
    overwrite exactly their rows; ``-1`` lanes write nothing.  Returns X.
    """
    if not X.is_contiguous():
        raise ValueError("scatter_active_rows: the carry leaf must be "
                         "contiguous to be updated in place")
    N = X.shape[0]
    A = workers.shape[0]
    flat_x = X.view(N, -1)
    flat_r = rows.reshape(A, -1).to(X.dtype).contiguous()
    idx = workers.to(torch.int32).contiguous()
    if X.device.type == "cpu":
        scatter_rows_plain(flat_x, flat_r, idx)
    else:
        scatter_rows_cuda(flat_x, flat_r, idx)
    return X

