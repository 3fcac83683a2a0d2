"""Optimizers as pure (init, update) pairs over flat parameter dicts.

The port of ``repro/optim/optimizers.py``: the same arithmetic, on
``dict[str, Tensor]`` (the flat dicts the port's models and trainers keep)
instead of pytrees.  DSGD-family algorithms use plain SGD at each worker
(eq. 4); momentum and AdamW serve centralized trainers and beyond-paper
experiments (decentralized Adam keeps per-worker moments; only parameters
are gossiped).  Nothing is updated in place: ``update`` returns new
updates and state, ``apply_updates`` new parameters.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params, eta) -> (updates, opt_state)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """p + u, cast back to each parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, eta):
        return {k: -eta * g for k, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum m ← β·m + g (in the parameters' dtype), the
    step −η·m, or −η·(β·m + g) with Nesterov."""
    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, m, params, eta):
        m = {k: beta * m[k] + g for k, g in grads.items()}
        if nesterov:
            upd = {k: -eta * (beta * m[k] + g) for k, g in grads.items()}
        else:
            upd = {k: -eta * mi for k, mi in m.items()}
        return upd, m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor   # int32 scalar


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with float32 moments whatever the parameters' dtype (bf16
    parameters keep float32 moments), an int32 step count, and the bias
    correction 1 − β^count in float32, as the reference writes it."""
    f32 = torch.float32

    def init(params):
        some = next(iter(params.values()))
        return AdamState(
            mu={k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=some.device))

    def update(grads, state, params, eta):
        c = state.count + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.to(f32)
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.to(f32))
              for k, g in grads.items()}
        c32 = c.to(f32)
        bc1, bc2 = 1 - b1 ** c32, 1 - b2 ** c32
        upd = {k: -eta * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                          + weight_decay * params[k].to(f32))
               for k in grads}
        return upd, AdamState(mu=mu, nu=nu, count=c)

    return Optimizer(init, update)


REGISTRY = {"sgd": sgd, "momentum": momentum, "adamw": adamw}


def make(name: str, **kw) -> Optimizer:
    return REGISTRY[name](**kw)
