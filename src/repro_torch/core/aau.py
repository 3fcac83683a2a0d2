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

With a :class:`~repro_torch.obs.metrics.MetricsCarry` ``M`` and the block's
telemetry arrays (``tel``: per-event or per-lane clocks, raw completion
clocks, event indices and copies), both blocks also advance ``M`` once per
event or row, as the reference's telemetry blocks do; the update reads the
event arrays and never the worker state, so the state's launches are the
same with or without it.

Semantics kept from the reference: padded no-op rows are skipped; η may be
per event ``(E,)`` or per lane ``(E, A)`` (merged rows); η is folded into
the 0/1 mask in float32 before the cast to the leaf dtype; ``ptr`` indexes
each worker's sample pool modulo the pool length.  Unlike the reference,
which donated the carry, the sparse block updates ``W``, ``S``, ``y`` and
``ptr`` in place and returns them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.gossip_mix.ops import gossip_mix, masked_gossip_mix
from repro_torch.kernels.sparse_gossip.ops import (active_set_operands,
                                                  mix_active_leaf,
                                                  scatter_active_rows)
from repro_torch.obs.metrics import (MetricsCarry, dense_metrics_update,
                                     sparse_metrics_update)
from repro_torch.utils.tree import Params

Carry = Tuple[Params, Params, torch.Tensor, torch.Tensor]
# A block's telemetry arrays (host NumPy): event / per-lane clocks, raw
# completion clocks, event indices, copies sent per event or row.
Telemetry = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _expand(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def to_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for queued device work.

    From pageable host memory the copy is staged before the call returns,
    so the source may be freed at once; ``non_blocking`` only spares the
    stream synchronisation a blocking copy would add.
    """
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:   # torch wraps only writable arrays
        a = a.copy()
    return torch.as_tensor(a).to(dtype).to(device, non_blocking=True)


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


# ---------------------------------------------------------------------------
# Sharded production gossip (send/recv over a worker process group)
# ---------------------------------------------------------------------------

def permute(x: torch.Tensor, group, perms: Sequence[Sequence[Tuple[int, int]]]
            ) -> List[torch.Tensor]:
    """The reference's ``jax.lax.ppermute`` of ``x`` for each permutation of
    ``perms``, all in one ``dist.batch_isend_irecv`` over ``group``.

    ``perms[e]`` lists (src, dst) pairs of group ranks; this rank receives
    the ``x`` of the src that names it (zeros where none does, as
    ``ppermute``) and sends its own to each dst.  Peers are global ranks
    (``dist.get_global_rank``).  Each permutation's sends and receives are
    posted in the order of ``perms`` with the permutation's index as their
    tag, so two permutations that reach the same peer (the ring's two
    directions at n = 2) match one to one."""
    import torch.distributed as dist
    me = dist.get_rank(group)
    ops, outs = [], []
    for e, perm in enumerate(perms):
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        out = torch.zeros_like(x) if not srcs else torch.empty_like(x)
        for d in dsts:
            if d == me:
                out.copy_(x)
            else:
                ops.append(dist.P2POp(dist.isend, x,
                                      dist.get_global_rank(group, d), group, e))
        for s_ in srcs:
            if s_ != me:
                ops.append(dist.P2POp(dist.irecv, out,
                                      dist.get_global_rank(group, s_), group, e))
        outs.append(out)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


def ring_perms(n: int) -> List[List[Tuple[int, int]]]:
    """The ring's two directions as ``ppermute`` pairs: forward delivers
    x_{j−1} to j, backward x_{j+1}."""
    return [[(i, (i + 1) % n) for i in range(n)],
            [((i + 1) % n, i) for i in range(n)]]


def ring_gossip(x: torch.Tensor, group, n: int, self_w: torch.Tensor,
                left_w: torch.Tensor, right_w: torch.Tensor) -> torch.Tensor:
    """Weighted ring gossip along a worker process group of ``n`` ranks,
    both directions in one batch of sends and receives.

    ``out_j = self_w·x_j + left_w·x_{j−1} + right_w·x_{j+1}`` (indices mod
    n), term by term in ``x``'s dtype as the reference writes it.  With the
    Metropolis ring weights (1/3 each) it is the doubly-stochastic mix of a
    static ring; a zero weight deactivates an edge (the buffers still
    move, as the reference's ``ppermute`` does).  At n = 1 nothing is sent.
    """
    if n == 1:
        return x
    from_left, from_right = permute(x, group, ring_perms(n))
    return self_w * x + left_w * from_left + right_w * from_right


def tree_ring_gossip(params: Params, group, n: int, self_w, left_w,
                     right_w) -> Params:
    """``ring_gossip`` of every leaf, the weights cast to the leaf's dtype."""
    def cast(w, p):
        return torch.as_tensor(w).to(device=p.device, dtype=p.dtype)
    return {k: ring_gossip(p, group, n, cast(self_w, p), cast(left_w, p),
                           cast(right_w, p))
            for k, p in params.items()}


def graph_gossip(x: torch.Tensor, group,
                 perms: Sequence[Sequence[Tuple[int, int]]],
                 weights: torch.Tensor, self_weight: torch.Tensor) -> torch.Tensor:
    """General static-topology gossip: one permutation per neighbour-offset
    class, all in one batch of sends and receives.

    ``perms[e]`` is a full permutation (list of (src, dst)) delivering each
    worker its e-th neighbour's shard; ``weights[e]`` scales that
    contribution.  For torus / multipod topologies where each worker has
    the same number of neighbour classes."""
    weights = torch.as_tensor(weights)
    out = torch.as_tensor(self_weight).to(device=x.device, dtype=x.dtype) * x
    for e, got in enumerate(permute(x, group, perms)):
        out = out + weights[e].to(device=x.device, dtype=x.dtype) * got
    return out


def tree_graph_gossip(params: Params, group, perms, weights,
                      self_weight) -> Params:
    return {k: graph_gossip(p, group, perms, weights, self_weight)
            for k, p in params.items()}


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
                       P_seq, grad_masks, restart_masks, etas,
                       M: Optional[MetricsCarry] = None,
                       tel: Optional[Telemetry] = None):
    """Advance (W, S, y, ptr) through a whole EventBatch.

    ``grad_fn(params, batch)`` is one worker's gradient; it is vmapped over
    the worker axis here.  P_seq: (E, n, n); grad_masks/restart_masks:
    (E, n) bools; etas: (E,); all host arrays.  ``ptr`` (n,) int32 counts
    each worker's restarts and picks its pool batch.  Identity-padded no-op
    events leave the carry exact.

    With ``M``, ``tel = (ts, fin, ks, copies)`` -- ts (E,) event clocks,
    fin (E, n) raw completion clocks, ks (E,) event indices, copies (E,)
    -- advance ``M`` once per event, and the return is ``(W, S, y, ptr,
    M)``.
    """
    dev = y.device
    P_seq = to_device(P_seq, torch.float32, dev)
    gms = to_device(grad_masks, torch.bool, dev)
    rms = to_device(restart_masks, torch.bool, dev)
    etas = to_device(etas, torch.float32, dev)
    if M is not None:
        ts, fin, ks, copies = tel
        # one copy: [e, 0] the event's clock, [e, 1:] the completions
        clocks = to_device(np.concatenate([np.asarray(ts)[:, None], fin],
                                          axis=1), torch.float32, dev)
    vgrad = torch.func.vmap(grad_fn)
    for e in range(P_seq.shape[0]):
        grads = vgrad(S, select_pool_batch(pools, ptr))
        W, S, y = masked_gossip_step(W, S, y, grads, P_seq[e], gms[e],
                                     rms[e], etas[e])
        ptr = ptr + rms[e].to(ptr.dtype)
        if M is not None:
            M = dense_metrics_update(M, P_seq[e], gms[e], rms[e],
                                     clocks[e, 0], clocks[e, 1:],
                                     int(ks[e]), int(copies[e]))
    if M is not None:
        return W, S, y, ptr, M
    return W, S, y, ptr


# ---------------------------------------------------------------------------
# Sparse active-set block
# ---------------------------------------------------------------------------

def sparse_gossip_scan(W: Params, S: Params, y: torch.Tensor,
                       ptr: torch.Tensor, pools: Params, grad_fn: Callable,
                       workers_seq: np.ndarray, P_sub_seq, grad_masks,
                       restart_masks, etas, M: Optional[MetricsCarry] = None,
                       tel: Optional[Telemetry] = None):
    """Advance (W, S, y, ptr) through a SparseEventBatch, in place.

    workers_seq: (E, A) int32 host array, ``-1``-padded; P_sub_seq:
    (E, A, A); grad_masks/restart_masks: (E, A) per-lane bools; etas: (E,)
    -- one step size per event -- or (E, A) per lane (merged block-diagonal
    rows, where one row replays several source events whose η differ).
    A row with no valid lane is a padded no-op and is skipped outright;
    the host decides that, and which lanes are valid, from ``workers_seq``.

    With ``M``, ``tel = (ts, fin, ks, copies)`` -- ts/fin (E, A) per-lane
    event and raw completion clocks, ks (E, A) per-lane event indices (a
    merged row carries each member event's own), copies (E,) -- advance
    ``M`` once per row that is not skipped, and the return is ``(W, S, y,
    ptr, M)``.
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
    if M is not None:
        ts, fin, ks, copies = tel
        # one copy: [e, :, 0] the lanes' clocks, [e, :, 1] completions
        clocks = to_device(np.stack([ts, fin], axis=-1), torch.float32, dev)
        ks_d = to_device(ks, torch.int32, dev)
    for e in range(E):
        if n_valid[e] == 0:
            continue
        W, S, y, ptr = sparse_event_update(
            W, S, y, ptr, pools, grad_fn, workers_d[e], P_d[e], gm_d[e],
            rm_d[e], eta_d[e], lanes_d[e, :int(n_valid[e])])
        if M is not None:
            M = sparse_metrics_update(M, workers_d[e], P_d[e], gm_d[e],
                                      rm_d[e], clocks[e, :, 0],
                                      clocks[e, :, 1], ks_d[e],
                                      int(copies[e]))
    if M is not None:
        return W, S, y, ptr, M
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
