"""Wrappers of the sparse_gossip and scatter_rows CUDA kernels.

The gather-compute-scatter contract of the active-set update, per leaf:

- ``sparse_gossip_rows`` returns the compact (A, ...) mixed rows
  P_subᵀ·(W[workers] − η·mask⊙G) (gather and mix fused in the kernel).
  It is ``active_set_operands`` -- the masked P, the folded Q and the
  clamped indices, which depend on the event and not on the leaf -- then
  ``mix_active_leaf`` on them; an event over several leaves calls the
  first once and the second per leaf;
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
from repro_torch.kernels.gossip_mix.ops import _BODIES, _split_p_scratch

_GOSSIP_PROTOTYPES = {
    "sparse_gossip_launch": (ctypes.c_int,) + (ctypes.c_void_p,) * 7
    + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    "sparse_gossip_kernels": (ctypes.c_int,),
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


def sparse_gossip_kernels(A: int) -> int:
    """Device kernels one ``sparse_gossip_cuda`` call launches at A lanes:
    the C dispatch's rule (1 for the CUDA-core body, 2 for the split
    prepass and the wgmma body).  Builds the library if needed."""
    return build.load("sparse_gossip", _GOSSIP_PROTOTYPES).sparse_gossip_kernels(A)


def sparse_gossip_cuda(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                       Q: torch.Tensor, gidx: torch.Tensor, *,
                       body: str | None = None) -> torch.Tensor:
    """The CUDA kernel: compact rows out (A, D) = Pᵀ·W[gidx] − Qᵀ·G.

    The C dispatch picks the body from A; ``body`` ("cores": the CUDA-core
    body, A ≤ 32 only; "tensor": the wgmma body) forces one, to measure or
    test both at one shape."""
    if body not in _BODIES:
        raise ValueError(f"sparse_gossip: body must be one of "
                         f"{sorted(map(str, _BODIES))}, got {body!r}")
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
    scratch = _split_p_scratch(1, A, dev, pairs=2)
    build.launch(
        lib, "sparse_gossip_launch", dev, build.DTYPE_CODES[W.dtype],
        W.data_ptr(), G.data_ptr(), P.data_ptr(), Q.data_ptr(),
        gidx.data_ptr(), out.data_ptr(), scratch.data_ptr(), N, A, D,
        _BODIES[body])
    sparse_gossip_cuda.launches += 1
    return out


sparse_gossip_cuda.launches = 0


def sparse_gossip_compact(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                          Q: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Compact mix: the plain version for CPU tensors, else the kernel."""
    if W.device.type == "cpu":
        return sparse_gossip_plain(W, G, P, Q, gidx)
    return sparse_gossip_cuda(W, G, P, Q, gidx)


def active_set_operands(P_sub: torch.Tensor, scaled_mask: torch.Tensor,
                        workers: torch.Tensor, dtype: torch.dtype):
    """The kernel's per-event operands (P, Q, gidx) of one active set.

    P = P_sub with the rows and columns of ``-1`` lanes zeroed, Q =
    diag(scaled_mask·valid)·P, both computed in P_sub's dtype, then cast
    to ``dtype`` (the leaves') and made contiguous; gidx the workers with
    ``-1`` lanes clamped to 0, int32.  They depend on the event only, so
    an event over several leaves builds them once.
    """
    valid = workers >= 0
    gidx = torch.where(valid, workers, 0).to(torch.int32).contiguous()
    vf = valid.to(P_sub.dtype)
    P = P_sub * vf[:, None] * vf[None, :]
    Q = (scaled_mask * vf).to(P.dtype)[:, None] * P
    return P.to(dtype).contiguous(), Q.to(dtype).contiguous(), gidx


def mix_active_leaf(W: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                    Q: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Compact rows Pᵀ·W[gidx] − Qᵀ·G of one (N, ...) leaf, from the
    operands of :func:`active_set_operands` (in W's dtype); G: (A, ...)."""
    N = W.shape[0]
    A = gidx.shape[0]
    flat_w = W.reshape(N, -1).contiguous()
    flat_g = G.reshape(A, -1).to(flat_w.dtype).contiguous()
    out = sparse_gossip_compact(flat_w, flat_g, P, Q, gidx)
    return out.reshape((A,) + tuple(W.shape[1:]))


def sparse_gossip_rows(W: torch.Tensor, G: torch.Tensor, P_sub: torch.Tensor,
                       scaled_mask: torch.Tensor,
                       workers: torch.Tensor) -> torch.Tensor:
    """Compact active-set event update rows for one (N, ...) leaf.

    out[b] = Σ_a P_sub[a, b]·(W[workers[a]] − scaled_mask[a]·G[a]) for the
    valid lanes; zero rows for ``-1``-padded lanes.  W: (N, ...); G: (A, ...)
    active-set gradients; P_sub: (A, A); scaled_mask: (A,) = η·grad_mask.
    """
    P, Q, gidx = active_set_operands(P_sub, scaled_mask, workers, W.dtype)
    return mix_active_leaf(W, G, P, Q, gidx)


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
    build.launch(
        lib, "scatter_rows_launch", dev, build.DTYPE_CODES[X.dtype],
        X.data_ptr(), rows.data_ptr(), workers.data_ptr(), N, A, D)
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

