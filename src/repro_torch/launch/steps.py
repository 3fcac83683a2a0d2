"""Step functions of the production training launcher: the decentralized
train_step, and the serve and prefill steps.

The port of ``repro/launch/steps.py``.  ``build_train_step`` produces the
DSGD-AAU update of ``python -m repro_torch.launch.train``:

  1. per-worker forward and backward of ``lm_loss`` (each layer and CE
     chunk rematerialised with ``remat``), each worker on its own non-iid
     batch shard; microbatches' gradients summed in float32;
  2. local SGD  W_i ← W_i − η·g_i  in float32, cast back (paper eq. 4);
  3. gossip along the worker axis: a ring with self / left / right
     weights streamed from the host per step, the paper's time-varying
     P(k) restricted to the ring.

On one card the N workers are a stacked leading axis of every leaf
(``W[key]`` is (N, ...)), so the reference's ``ppermute`` ring is a fixed
(N, N) mixing matrix (``ring_matrix``) applied to each leaf by the
``gossip_mix`` kernel.  A zero weight deactivates an edge, and the kernel
still runs, as the reference's collective still moves its bytes.  The
reference's inter-pod edge (``--multipod``) belongs to the sharded launch
stack (ROADMAP A5) and raises here.

The gradients come from ``torch.autograd.grad`` one worker at a time, not
from ``torch.func``: ``torch.func`` cannot carry the rematerialisation's
saved-tensor hooks (``models.layers.rematerialise``).  A worker's
gradients are applied and freed before the next worker's are taken, so the
peak holds one worker's gradients, not N.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.models.transformer import (decode_step, flat_params,
                                            init_model, lm_loss, prefill)

Tree = Dict[str, torch.Tensor]
f32 = torch.float32


def stacked_init(cfg: ModelConfig, n_workers: int,
                 gen: Optional[torch.Generator],
                 device: DeviceLike = "cuda") -> Tree:
    """Worker-stacked parameters {key: (N, ...)}, the same init (drawn from
    ``gen``) for every worker, each leaf its own memory so that it can be
    written in place.  The model's own copy of a leaf is released as soon
    as it is stacked."""
    model = init_model(cfg, gen, resolve_device(device))
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


def ring_matrix(n: int, weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The (N, N) float32 matrix P of the reference's ring gossip, out =
    Pᵀ·W: out_j = self·x_j + left·x_{j−1} + right·x_{j+1} (indices mod N;
    ``ppermute`` pairs (i, i+1) deliver x_i to worker i+1).  At N = 2 left
    and right reach the same worker and add; at N = 1 self is alone."""
    if float(weights.get("pod", 0.0)) != 0.0:
        raise NotImplementedError(
            "the inter-pod gossip edge belongs to the sharded launch stack "
            "(ROADMAP A5)")
    w = {k: torch.as_tensor(weights[k], dtype=f32).cpu()
         for k in ("self", "left", "right")}
    P = torch.zeros((n, n), dtype=f32)
    for j in range(n):
        P[j, j] += w["self"]
        if n > 1:
            P[(j - 1) % n, j] += w["left"]
            P[(j + 1) % n, j] += w["right"]
    return P


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


def build_train_step(cfg: ModelConfig, n_workers: int, *, microbatch: int = 1,
                     logit_chunk: int = 512, remat: bool = True,
                     device: DeviceLike = "cuda") -> Callable:
    """Returns ``train_step(W, batch, eta, gossip_w, on_mix=None) -> (W,
    loss)``.

    W: {key: (N, ...)} on ``device``, updated in place (the reference
    donates it); batch: {"tokens": (N, b, T) int, ["prefix": (N, b, P,
    d)]}; eta: the step size; gossip_w: {"self", "left", "right", "pod"}
    float32 scalars (``default_gossip_weights``).  Returns W and the
    workers' mean loss (a float32 scalar tensor).  With ``microbatch`` > 1
    each worker's batch splits into that many microbatches whose float32
    gradients are summed and divided, as the reference's scan does.
    """
    resolve_device(device)

    def worker_loss(params, tokens, prefix):
        b = {"tokens": tokens}
        if prefix is not None:
            b["prefix"] = prefix
        return lm_loss(params, cfg, b, logit_chunk=logit_chunk, remat=remat)

    def grads_of(params, tokens, prefix):
        loss = worker_loss(params, tokens, prefix)
        return loss.detach(), list(torch.autograd.grad(loss, list(params.values())))

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

    def train_step(W: Tree, batch, eta, gossip_w, on_mix=None):
        tokens = batch["tokens"]
        prefix = batch.get("prefix")
        eta32 = torch.as_tensor(eta, dtype=f32).to(tokens.device)
        losses = []
        for i in range(n_workers):
            params = {k: w[i].detach().requires_grad_() for k, w in W.items()}
            loss, g = worker_grad(params, tokens[i],
                                  prefix[i] if prefix is not None else None)
            losses.append(loss)
            del params
            for j, w in enumerate(W.values()):
                step = g[j].to(f32).mul_(eta32)
                g[j] = None                      # free as we go
                w[i].copy_(w[i].to(f32).sub_(step))
                del step
        _tree_gossip(W, ring_matrix(n_workers, gossip_w), on_mix)
        return W, torch.stack(losses).mean()

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
