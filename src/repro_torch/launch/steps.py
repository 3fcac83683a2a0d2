"""Step functions of the production training launcher: the decentralized
train_step (stacked on one card, or sharded over ranks), and the serve and
prefill steps.

The port of ``repro/launch/steps.py``.  Both train steps produce the
DSGD-AAU update of ``python -m repro_torch.launch.train``:

  1. per-worker forward and backward of ``lm_loss`` (each layer and CE
     chunk rematerialised with ``remat``), each worker on its own non-iid
     batch shard; microbatches' gradients summed in float32;
  2. local SGD  W_i ← W_i − η·g_i  in float32, cast back (paper eq. 4);
  3. gossip along the worker axis: a ring with self / left / right
     weights streamed from the host per step, the paper's time-varying
     P(k) restricted to the ring, and on the multi-pod mesh the inter-pod
     edge: out = (1−γ)·ring + γ·(the other pod's same worker).

``build_train_step`` (one card, no process group): the N workers are a
stacked leading axis of every leaf (``W[key]`` is (N, ...)), so the
reference's ``ppermute`` ring, and the pod edge, are one fixed (N, N)
mixing matrix (``ring_matrix``) applied to each leaf by the ``gossip_mix``
kernel.  A zero weight deactivates an edge, and the kernel still runs, as
the reference's collective still moves its bytes.

``build_sharded_train_step`` (``torch.distributed``, one rank per device
of the production mesh view, ``launch/mesh.py``): a worker's replica is
sharded over its (fsdp, model) ranks (DTensors placed by
``launch/sharding.py:param_pspecs``); each step gathers it, takes the
worker's gradients on the worker's whole batch on every rank of the
worker, applies SGD to the rank's own shard and gossips the shards with
send/recv (``core/aau.py:ring_gossip``), as the reference's ``shard_map``
gossip does.

The gradients come from ``torch.autograd.grad`` one worker at a time, not
from ``torch.func``: ``torch.func`` cannot carry the rematerialisation's
saved-tensor hooks (``models.layers.rematerialise``).  A worker's
gradients are applied and freed before the next worker's are taken, so the
peak holds one worker's gradients, not N.

While a torch profiler runs, both train steps record host spans
(:mod:`repro_torch.obs.spans`): ``train.step``, ``train.forward``,
``train.backward`` and ``train.gossip``, and in the stacked step
``train.worker`` and ``train.sgd``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aau import permute, ring_gossip
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.launch.mesh import TrainAxes
from repro_torch.launch.sharding import local_shard, placements
from repro_torch.models.layers import ATTENTION_ROUTES
from repro_torch.models.transformer import (decode_step, flat_params,
                                            init_model, lm_loss, prefill)
from repro_torch.obs.spans import span

Tree = Dict[str, torch.Tensor]
f32 = torch.float32


def stacked_init(cfg: ModelConfig, n_workers: int,
                 gen: Optional[torch.Generator],
                 device: DeviceLike = "cuda") -> Tree:
    """Worker-stacked parameters {key: (N, ...)}, the same init (drawn from
    ``gen``) for every worker, each leaf its own memory so that it can be
    written in place.  The model's own copy of a leaf is released as soon
    as it is stacked.  ``device="meta"`` with ``gen`` None gives the shapes
    alone (the dry run)."""
    model = init_model(cfg, gen, device)
    W = {}
    for k, p in flat_params(model).items():
        W[k] = p.detach().unsqueeze(0).expand(n_workers, *p.shape).clone()
        p.data = p.data.new_empty(0)
    return W


def gossip_weights_spec() -> Dict[str, torch.Tensor]:
    """Abstract gossip weights: (self, left, right, pod) float32 scalars,
    as meta tensors (shape and dtype only)."""
    return {k: torch.empty((), dtype=f32, device="meta")
            for k in ("self", "left", "right", "pod")}


def default_gossip_weights(n_workers_per_pod: int,
                           multi_pod: bool) -> Dict[str, torch.Tensor]:
    """The reference's ring weights: 1/3 each from three workers on, self
    1/2 and each side 1/4 for two, self alone for one; the pod edge 1/4 on
    the multi-pod mesh."""
    if n_workers_per_pod >= 3:
        w = {"self": 1 / 3, "left": 1 / 3, "right": 1 / 3}
    elif n_workers_per_pod == 2:
        w = {"self": 0.5, "left": 0.25, "right": 0.25}
    else:
        w = {"self": 1.0, "left": 0.0, "right": 0.0}
    w["pod"] = 0.25 if multi_pod else 0.0
    return {k: torch.tensor(v, dtype=f32) for k, v in w.items()}


def ring_matrix(n: int, weights: Dict[str, torch.Tensor],
                pods: int = 1) -> torch.Tensor:
    """The (N, N) float32 matrix P of the reference's gossip, out = Pᵀ·W.

    One pod: the ring, out_j = self·x_j + left·x_{j−1} + right·x_{j+1}
    (indices mod N; ``ppermute`` pairs (i, i+1) deliver x_i to worker
    i+1).  At N = 2 left and right reach the same worker and add; at N = 1
    self is alone.  ``weights["pod"]`` is not read, as the reference reads
    it only on a mesh with a pod axis.

    Two pods of m = N/2 workers, global index pod·m + worker: each pod's
    ring R of the three weights, and the inter-pod edge γ =
    ``weights["pod"]`` to the other pod's same worker,
    P = (1−γ)·blockdiag(R, R) + γ·[[0, I], [I, 0]]."""
    if pods not in (1, 2) or n % pods:
        raise ValueError(f"{n} workers do not split into {pods} pods")
    w = {k: torch.as_tensor(weights[k], dtype=f32).cpu()
         for k in ("self", "left", "right")}
    m = n // pods
    R = torch.zeros((m, m), dtype=f32)
    for j in range(m):
        R[j, j] += w["self"]
        if m > 1:
            R[(j - 1) % m, j] += w["left"]
            R[(j + 1) % m, j] += w["right"]
    if pods == 1:
        return R
    g = torch.as_tensor(weights["pod"], dtype=f32).cpu()
    swap = torch.eye(n, dtype=f32).roll(m, 0)       # [[0, I], [I, 0]]
    return (1 - g) * torch.block_diag(R, R) + g * swap


def _tree_gossip(W: Tree, P: torch.Tensor,
                 on_mix: Optional[Callable] = None) -> Tree:
    """Mix every (N, ...) leaf of ``W`` with P (out = Pᵀ·W): one
    ``gossip_mix`` launch per leaf, P in the leaf's dtype as the reference
    casts its weights (copied to the device once per dtype).  Each leaf
    is replaced in ``W`` as its output lands, which frees its pre-gossip
    tensor.  ``on_mix(key, before, after)`` sees each leaf's pair first
    (instrumentation).

    The kernel sums in float32 and rounds once; the reference sums the
    bf16 terms one rounded add at a time, so bf16 leaves agree within the
    bf16 bound, not bit for bit (float32 within the float32 tolerance)."""
    with span("train.gossip") as counts:
        if counts is not None:      # each leaf read and written once
            counts["bytes"] = sum(2 * w.numel() * w.element_size()
                                  for w in W.values())
        Ps = {}
        for k in list(W):
            dt = W[k].dtype
            if dt not in Ps:
                Ps[dt] = P.to(device=W[k].device, dtype=dt)
            out = gossip_mix(W[k], Ps[dt])
            if on_mix is not None:
                on_mix(k, W[k], out)
            W[k] = out
        return W


def worker_grad_fn(cfg: ModelConfig, *, microbatch: int = 1,
                   logit_chunk: int = 512, remat: bool = True) -> Callable:
    """``grad(params, tokens, prefix) -> (loss, [gradient of each leaf])``
    of one worker's ``lm_loss`` on its batch (b, T), by
    ``torch.autograd.grad``.  With ``microbatch`` > 1 the batch splits
    into that many microbatches whose float32 gradients are summed and
    divided, as the reference's scan does."""
    def grads_of(params, tokens, prefix):
        b = {"tokens": tokens}
        if prefix is not None:
            b["prefix"] = prefix
        with span("train.forward") as counts:
            before = dict(ATTENTION_ROUTES) if counts is not None else None
            loss = lm_loss(params, cfg, b, logit_chunk=logit_chunk,
                           remat=remat)
            if counts is not None:   # the attention calls of this lm_loss
                counts.update({k: n - before[k]
                               for k, n in ATTENTION_ROUTES.items()})
        with span("train.backward"):
            grads = list(torch.autograd.grad(loss, list(params.values())))
        return loss.detach(), grads

    def worker_grad(params, tokens, prefix):
        if microbatch == 1:
            return grads_of(params, tokens, prefix)
        tb = tokens.reshape(microbatch, -1, tokens.shape[-1])
        pb = (prefix.reshape((microbatch, -1) + tuple(prefix.shape[1:]))
              if prefix is not None else None)
        tot = torch.zeros((), dtype=f32, device=tokens.device)
        acc = [torch.zeros(p.shape, dtype=f32, device=p.device)
               for p in params.values()]
        for i in range(microbatch):
            loss, g = grads_of(params, tb[i], pb[i] if pb is not None else None)
            for a, gi in zip(acc, g):
                a.add_(gi.to(f32))
            tot = tot + loss
        g = [(a / microbatch).to(p.dtype) for a, p in zip(acc, params.values())]
        return tot / microbatch, g

    return worker_grad


def sgd_(w: torch.Tensor, g: torch.Tensor, eta32: torch.Tensor) -> None:
    """w ← (w − η·g) in float32, cast back to w's dtype, in place."""
    w.copy_(w.to(f32).sub_(g.to(f32).mul_(eta32)))


def build_train_step(cfg: ModelConfig, n_workers: int, *, microbatch: int = 1,
                     logit_chunk: int = 512, remat: bool = True,
                     pods: int = 1, device: DeviceLike = "cuda") -> Callable:
    """Returns ``train_step(W, batch, eta, gossip_w, on_mix=None) -> (W,
    loss)``, the workers stacked on one device.

    W: {key: (N, ...)} on ``device``, updated in place (the reference
    donates it); batch: {"tokens": (N, b, T) int, ["prefix": (N, b, P,
    d)]}; eta: the step size; gossip_w: {"self", "left", "right", "pod"}
    float32 scalars (``default_gossip_weights``).  ``pods`` = 2 splits
    the N workers into two pods joined by the ``pod`` edge
    (``ring_matrix``).  Returns W and the workers' mean loss (a float32
    scalar tensor).
    """
    resolve_device(device)
    worker_grad = worker_grad_fn(cfg, microbatch=microbatch,
                                 logit_chunk=logit_chunk, remat=remat)

    def train_step(W: Tree, batch, eta, gossip_w, on_mix=None):
        tokens = batch["tokens"]
        prefix = batch.get("prefix")
        with span("train.step", tokens=tokens.numel()):
            eta32 = torch.as_tensor(eta, dtype=f32).to(tokens.device)
            losses = []
            per_worker = tokens.numel() // n_workers
            for i in range(n_workers):
                with span("train.worker", worker=i, tokens=per_worker):
                    params = {k: w[i].detach().requires_grad_()
                              for k, w in W.items()}
                    loss, g = worker_grad(
                        params, tokens[i],
                        prefix[i] if prefix is not None else None)
                    losses.append(loss)
                    del params
                    with span("train.sgd"):
                        for j, w in enumerate(W.values()):
                            sgd_(w[i], g[j], eta32)
                            g[j] = None          # free as we go
            _tree_gossip(W, ring_matrix(n_workers, gossip_w, pods), on_mix)
            return W, torch.stack(losses).mean()

    return train_step


# ---------------------------------------------------------------------------
# Sharded over ranks (torch.distributed)
# ---------------------------------------------------------------------------

def replica_mesh(mesh, axes: TrainAxes):
    """The sub-mesh of one worker's replica: its (fsdp, model) ranks."""
    names = tuple(a for a in (axes.fsdp, axes.model) if a)
    return mesh[names] if len(names) > 1 else mesh[names[0]]


def worker_index(mesh, axes: TrainAxes) -> int:
    """This rank's worker, pod·(workers a pod) + worker, as the reference's
    worker-stacked leading axis numbers them."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    size = dict(zip(names, mesh.shape))
    return (coord[axes.pod] * size[axes.worker] if axes.pod else 0) + coord[axes.worker]


def shard_replica(params: Tree, mesh, axes: TrainAxes,
                  param_specs: Dict[str, tuple]) -> Tree:
    """A worker's whole replica {key: leaf} (the same on every rank of the
    worker) as DTensors on its ``replica_mesh``, each rank keeping its own
    shard (no communication).  ``param_specs`` carry the worker-stack entry
    first (``param_pspecs(..., worker_axes=...)``)."""
    from torch.distributed.tensor import DTensor
    sub = replica_mesh(mesh, axes)
    out = {}
    for k, p in params.items():
        pl = placements(param_specs[k][1:], sub)
        out[k] = DTensor.from_local(local_shard(p, sub, pl), sub, pl,
                                    run_check=False)
    return out


def gather_workers(W: Tree, mesh, axes: TrainAxes) -> Tree:
    """Every worker's whole replica, stacked {key: (N, ...)} in worker
    order, on every rank (a checkpoint's gather: each replica gathered over
    its ranks, then over the worker and pod axes)."""
    import torch.distributed as dist
    out = {}
    for k, w in W.items():
        rep = w.full_tensor()
        for axis in (axes.worker, axes.pod):
            if axis is None:
                continue
            group = mesh.get_group(axis)
            parts = [torch.empty_like(rep)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, rep.contiguous(), group=group)
            rep = (torch.stack(parts) if axis == axes.worker
                   else torch.cat(parts))
        out[k] = rep
    return out


def build_sharded_train_step(cfg: ModelConfig, n_workers: int,
                             axes: TrainAxes, mesh, param_specs, *,
                             microbatch: int = 1, logit_chunk: int = 512,
                             remat: bool = True) -> Callable:
    """Returns ``step(W, batch, eta, gossip_w) -> (W, loss)`` of one rank.

    W: {key: DTensor} of this rank's worker, placed by ``param_specs`` on
    its ``replica_mesh`` (``shard_replica``); batch: {"tokens": (b, T),
    ["prefix": (b, P, d)]}, the worker's own batch (``worker_index``).
    Each step gathers the replica (``full_tensor``), takes the worker's
    loss and gradients on its whole batch (every rank of the worker
    computes the same values), applies float32 SGD to the rank's own shard,
    then gossips the shards: the ring over ``axes.worker`` in the leaf's
    dtype, and on the multi-pod mesh out = (1−γ)·ring + γ·(the other pod's
    shard) over ``axes.pod``, term by term as the reference's
    ``_tree_gossip``.  Mixing is elementwise, so each rank exchanges its
    shard with the ranks of the neighbouring workers that hold the same
    (fsdp, model) coordinate: the worker group's ranks.  Returns the new W
    and the workers' mean loss (an all-reduce over every rank: the ranks
    of a worker hold the same loss).

    The batch is not split inside a worker: an MoE's capacity depends on
    the token count and its load-balance loss on the whole batch, so a
    split would change their results.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    sub = replica_mesh(mesh, axes)
    place = {k: placements(spec[1:], sub) for k, spec in param_specs.items()}
    worker_group = mesh.get_group(axes.worker)
    pod_group = mesh.get_group(axes.pod) if axes.pod else None
    n = n_workers // (2 if axes.pod else 1)
    worker_grad = worker_grad_fn(cfg, microbatch=microbatch,
                                 logit_chunk=logit_chunk, remat=remat)

    def mix(x, gw):
        dt = x.dtype
        w = {k: torch.as_tensor(v).to(device=x.device, dtype=dt)
             for k, v in gw.items()}
        ring = (w["self"] * x if n == 1 else
                ring_gossip(x, worker_group, n, w["self"], w["left"], w["right"]))
        if pod_group is not None:
            other, = permute(x, pod_group, [[(0, 1), (1, 0)]])
            ring = (1 - w["pod"]) * ring + w["pod"] * other
        return ring

    def train_step(W: Tree, batch, eta, gossip_w):
        tokens = batch["tokens"]
        prefix = batch.get("prefix")
        with span("train.step", tokens=tokens.numel()):
            eta32 = torch.as_tensor(eta, dtype=f32).to(tokens.device)
            params = {k: w.full_tensor().detach().requires_grad_()
                      for k, w in W.items()}
            loss, g = worker_grad(params, tokens, prefix)
            del params
            out = {}
            for j, (k, w) in enumerate(W.items()):
                shard = w.to_local().clone()
                sgd_(shard, local_shard(g[j], sub, place[k]), eta32)
                g[j] = None
                with span("train.gossip",
                          bytes=2 * shard.numel() * shard.element_size()):
                    mixed = mix(shard, gossip_w)
                out[k] = DTensor.from_local(mixed, sub, place[k],
                                            run_check=False)
            loss = loss.to(f32).clone()
            dist.all_reduce(loss)
            return out, loss / dist.get_world_size()

    return train_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, token, state, pos) -> (logits, new_state)."""
    def serve_step(params, token, state, pos):
        return decode_step(params, cfg, token, state, pos)
    return serve_step


def build_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    """prefill_step(params, batch) -> (last logits, decode state)."""
    def prefill_step(params, batch):
        return prefill(params, cfg, batch["tokens"], cache_len,
                       prefix_embeds=batch.get("prefix"))
    return prefill_step
