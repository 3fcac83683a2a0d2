"""DSGD-AAU parameter updates in PyTorch.

The port of the reference's ``repro/core/aau.py`` for the simulator's
paths; all apply eq. (5), ``W(k) = [W(k−1) − ηG] P(k)``, to stacked worker
state: every leaf of the parameter dict ``W`` (and of the snapshot dict
``S``) carries a leading worker axis N, and ``y`` holds the push-sum weights
(float32 whatever the leaf dtype).

1. **Per-event step** (`build_event_step`): one event at a time, the
   reference's legacy interpreter.  Gradients at every worker's snapshot,
   the elementwise step W − η·mask⊙G, then ``gossip_mix_dense``: one
   ``gossip_mix`` kernel launch per leaf, Pᵀ·(W − η·mask⊙G).

2. **Dense block** (`masked_gossip_scan`): one :class:`EventBatch` of E
   events, each an (N, N) consensus matrix with (N,) gradient/restart masks.
   Per event every worker's gradient is evaluated at its snapshot on its
   current pool batch, and each leaf takes one ``masked_gossip`` kernel
   launch, the same Pᵀ·(W − η·mask⊙G) with the step folded into the mix.

3. **Sparse active-set block** (`sparse_gossip_scan`): one
   :class:`SparseEventBatch` of E events over ``-1``-padded lane sets of
   width A.  Per event it gathers the active lanes' snapshots and pool
   batches, evaluates gradients for those lanes only, mixes each leaf with
   the A×A submatrix (one ``sparse_gossip`` launch) and scatters the rows
   back into W and S in place (two ``scatter_rows`` launches).  The fused
   mode (:mod:`repro_torch.core.fused`) applies the same event update
   (`sparse_event_update`) to events it generates on the device.

The reference runs a block as one ``lax.scan``; here a block is a Python
loop over its events, every launch queued on PyTorch's current stream.  The
event arrays arrive as host NumPy and go to the device once per block; the
per-event decisions (skipping no-op rows, the valid lanes of a row) are made
from the host copy, so the loop never waits on the device.  For CUDA tensors
the ops launch the hand-written kernels; for CPU tensors they run the plain
PyTorch versions (the tests' path).

Semantics kept from the reference: padded no-op rows are skipped; η may be
per event ``(E,)`` or per lane ``(E, A)`` (merged rows); η is folded into
the 0/1 mask in float32 before the cast to the leaf dtype; ``ptr`` indexes
each worker's sample pool modulo the pool length.  Unlike the reference,
which donated the carry, the sparse block updates ``W``, ``S``, ``y`` and
``ptr`` in place and returns them.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.gossip_mix.ops import gossip_mix, masked_gossip_mix
from repro_torch.kernels.sparse_gossip.ops import (active_set_operands,
                                                  mix_active_leaf,
                                                  scatter_active_rows)
from repro_torch.utils.tree import Params

Carry = Tuple[Params, Params, torch.Tensor, torch.Tensor]


def _expand(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def to_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for queued device work.

    From pageable host memory the copy is staged before the call returns,
    so the source may be freed at once; ``non_blocking`` only spares the
    stream synchronisation a blocking copy would add.
    """
    t = torch.as_tensor(np.ascontiguousarray(x)).to(dtype)
    return t.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Stacked-worker updates
# ---------------------------------------------------------------------------

def gossip_mix_dense(W: Params, P: torch.Tensor) -> Params:
    """out[j] = Σ_i P[i, j] · W[i] for every leaf (leading axis = worker):
    one ``gossip_mix`` launch per leaf on the card."""
    return {k: gossip_mix(x, P.to(x.dtype)) for k, x in W.items()}


def masked_gossip_step(W: Params, S: Params, y: torch.Tensor, grads: Params,
                       P: torch.Tensor, grad_mask: torch.Tensor,
                       restart_mask: torch.Tensor, eta: torch.Tensor,
                       fold_step: bool = True
                       ) -> Tuple[Params, Params, torch.Tensor]:
    """One event applied to stacked worker state; returns (W', S', y').

    W: current parameters, leading axis N; S: the snapshots the gradients
    were evaluated at; y: push-sum weights; grads: ∇F_j at S (all workers,
    masked here); P: (N, N); masks: (N,) bool; eta: float32 scalar.
    ``fold_step`` folds the gradient step into the mix (one
    ``masked_gossip`` launch per leaf, the dense scan's form); without it
    the step W − η·mask⊙G is taken elementwise and mixed by
    ``gossip_mix_dense`` (the reference's default per-event form).
    """
    # fold η into the 0/1 mask in float32 (exact: the product is η or 0),
    # then cast per leaf, so a bf16 state stays bf16 through the update
    scaled = eta * grad_mask.to(torch.float32)
    if fold_step:
        Wn = {k: masked_gossip_mix(w, grads[k], P.to(w.dtype),
                                   scaled.to(w.dtype))
              for k, w in W.items()}
    else:
        Wn = gossip_mix_dense({k: w - _expand(scaled, w) * grads[k]
                               for k, w in W.items()}, P)
    yn = torch.einsum("n,nj->j", y, P.to(y.dtype))
    Sn = {k: torch.where(_expand(restart_mask, Wn[k]) > 0, Wn[k], s)
          for k, s in S.items()}
    return Wn, Sn, yn


def build_event_step(loss_fn: Callable) -> Callable:
    """step(W, S, y, batches, P, grad_mask, restart_mask, eta) -> (W', S', y').

    ``loss_fn(params, batch) -> scalar``; ``batches`` carry a leading worker
    axis.  Gradients are evaluated at the snapshots S (staleness-correct),
    then the unfolded step: W − η·mask⊙G elementwise, ``gossip_mix_dense``.
    """
    vgrad = torch.func.vmap(torch.func.grad(loss_fn))

    def step(W, S, y, batches, P, grad_mask, restart_mask, eta):
        grads = vgrad(S, batches)
        return masked_gossip_step(W, S, y, grads, P, grad_mask, restart_mask,
                                  eta, fold_step=False)

    return step


def debiased_average(W: Params, y: torch.Tensor) -> Params:
    """Network average of push-sum de-biased estimates: mean_j (W_j / y_j)."""
    return {k: torch.mean(x / _expand(y, x), dim=0) for k, x in W.items()}


def select_pool_batch(pools: Params, ptr: torch.Tensor) -> Params:
    """Each worker's current batch: worker i gets ``pool[i, ptr[i] mod pool]``."""
    out = {}
    for k, pool in pools.items():
        rows = torch.arange(pool.shape[0], device=pool.device)
        out[k] = pool[rows, (ptr % pool.shape[1]).long()]
    return out


def select_pool_batch_at(pools: Params, widx: torch.Tensor,
                         ptra: torch.Tensor) -> Params:
    """Active-set batches: lane a gets ``pool[widx[a], ptra[a] mod pool]``."""
    return {k: pool[widx.long(), (ptra % pool.shape[1]).long()]
            for k, pool in pools.items()}


# ---------------------------------------------------------------------------
# Dense block
# ---------------------------------------------------------------------------

def masked_gossip_scan(W: Params, S: Params, y: torch.Tensor,
                       ptr: torch.Tensor, pools: Params, grad_fn: Callable,
                       P_seq, grad_masks, restart_masks, etas) -> Carry:
    """Advance (W, S, y, ptr) through a whole EventBatch.

    ``grad_fn(params, batch)`` is one worker's gradient; it is vmapped over
    the worker axis here.  P_seq: (E, n, n); grad_masks/restart_masks:
    (E, n) bools; etas: (E,); all host arrays.  ``ptr`` (n,) int32 counts
    each worker's restarts and picks its pool batch.  Identity-padded no-op
    events leave the carry exact.
    """
    dev = y.device
    P_seq = to_device(P_seq, torch.float32, dev)
    gms = to_device(grad_masks, torch.bool, dev)
    rms = to_device(restart_masks, torch.bool, dev)
    etas = to_device(etas, torch.float32, dev)
    vgrad = torch.func.vmap(grad_fn)
    for e in range(P_seq.shape[0]):
        grads = vgrad(S, select_pool_batch(pools, ptr))
        W, S, y = masked_gossip_step(W, S, y, grads, P_seq[e], gms[e],
                                     rms[e], etas[e])
        ptr = ptr + rms[e].to(ptr.dtype)
    return W, S, y, ptr


# ---------------------------------------------------------------------------
# Sparse active-set block
# ---------------------------------------------------------------------------

def sparse_gossip_scan(W: Params, S: Params, y: torch.Tensor,
                       ptr: torch.Tensor, pools: Params, grad_fn: Callable,
                       workers_seq: np.ndarray, P_sub_seq, grad_masks,
                       restart_masks, etas) -> Carry:
    """Advance (W, S, y, ptr) through a SparseEventBatch, in place.

    workers_seq: (E, A) int32 host array, ``-1``-padded; P_sub_seq:
    (E, A, A); grad_masks/restart_masks: (E, A) per-lane bools; etas: (E,)
    -- one step size per event -- or (E, A) per lane (merged block-diagonal
    rows, where one row replays several source events whose η differ).
    A row with no valid lane is a padded no-op and is skipped outright;
    the host decides that, and which lanes are valid, from ``workers_seq``.
    """
    workers_np = np.asarray(workers_seq)
    E, A = workers_np.shape
    etas = np.asarray(etas, dtype=np.float32)
    if etas.ndim == 1:
        etas = np.broadcast_to(etas[:, None], (E, A))
    valid = workers_np >= 0
    n_valid = valid.sum(axis=1)
    # each row's valid lanes first, in lane order: lanes[e, :n_valid[e]]
    lanes = np.argsort(~valid, axis=1, kind="stable")
    dev = y.device
    workers_d = to_device(workers_np, torch.int32, dev)
    lanes_d = to_device(lanes, torch.int64, dev)
    P_d = to_device(P_sub_seq, torch.float32, dev)
    gm_d = to_device(grad_masks, torch.bool, dev)
    rm_d = to_device(restart_masks, torch.bool, dev)
    eta_d = to_device(etas, torch.float32, dev)
    for e in range(E):
        if n_valid[e] == 0:
            continue
        W, S, y, ptr = sparse_event_update(
            W, S, y, ptr, pools, grad_fn, workers_d[e], P_d[e], gm_d[e],
            rm_d[e], eta_d[e], lanes_d[e, :int(n_valid[e])])
    return W, S, y, ptr


def sparse_event_update(W: Params, S: Params, y: torch.Tensor,
                        ptr: torch.Tensor, pools: Params, grad_fn: Callable,
                        workers: torch.Tensor, P_sub: torch.Tensor,
                        gm: torch.Tensor, rm: torch.Tensor, eta: torch.Tensor,
                        lanes: Optional[torch.Tensor] = None) -> Carry:
    """One active-set event against the stacked carry, in place.

    workers: (A,) ``-1``-padded; P_sub: (A, A); gm/rm: (A,) bools; eta:
    scalar or (A,) per lane; lanes: int64 positions of the valid lanes,
    where the host knows them.  With ``lanes=None`` the valid lanes are
    found on the device: every padded lane rewrites the first valid lane's
    row of y and ptr with that lane's own values, so the writes need no
    host sync (at least one lane must be valid).
    Returns the same ``(W, S, y, ptr)`` objects, updated.
    """
    valid = workers >= 0
    gidx = torch.where(valid, workers, 0).long()
    if lanes is None:
        pos = torch.arange(valid.shape[0], device=valid.device)
        lanes = torch.where(valid, pos, torch.argmax(valid.to(torch.int32)))
    # -- gather: only the A active lanes' snapshots, counters and batches
    Sa = {k: s.index_select(0, gidx) for k, s in S.items()}
    ptra = ptr.index_select(0, gidx)
    batches = select_pool_batch_at(pools, gidx, ptra)
    grads = torch.func.vmap(grad_fn)(Sa, batches)
    scaled = eta * (gm & valid).to(torch.float32)
    # -- compute: P_subᵀ·(W_a − η·mask⊙G), one sparse_gossip launch per
    # leaf; the masked P, folded Q and indices are the event's, built once
    # per dtype of the leaves
    operands = {}
    Wn = {}
    for k, w in W.items():
        if w.dtype not in operands:
            operands[w.dtype] = active_set_operands(
                P_sub.to(w.dtype), scaled.to(w.dtype), workers, w.dtype)
        Wn[k] = mix_active_leaf(w, grads[k], *operands[w.dtype])
    ya = torch.einsum("a,ab->b", y.index_select(0, gidx), P_sub.to(y.dtype))
    Sn = {k: torch.where(_expand(rm, Wn[k]) > 0, Wn[k], sa)
          for k, sa in Sa.items()}
    # -- scatter: the (N, D) leaves through the in-place kernel, the O(N)
    # vectors y and ptr by plain indexing over the valid lanes
    for k, w in W.items():
        scatter_active_rows(w, Wn[k], workers)
    for k, s in S.items():
        scatter_active_rows(s, Sn[k], workers)
    widx = gidx.index_select(0, lanes)
    y.index_copy_(0, widx, ya.index_select(0, lanes).to(y.dtype))
    ptr.index_copy_(0, widx,
                    (ptra + rm.to(ptr.dtype)).index_select(0, lanes))
    return W, S, y, ptr
