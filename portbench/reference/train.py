"""The plain reference of the decentralized training cells: N workers on a
ring, each a replica of the plain decoder (``model.py``) in the
configuration's parameter dtype, stepping together.

A step, per worker i on its own batch: the gradient g_i of its loss at
W_i, computed in float32 and delivered in the parameter dtype; the SGD
update W_i ← W_i − η·g_i in float32, rounded once to the parameter dtype;
then the ring's gossip out_j = s·W_j + l·W_{j−1} + r·W_{j+1} (indices mod
N), its weights in the parameter dtype, summed in float32 and rounded
once.  A straggler round sets s = 1, l = r = 0.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench import inputs
from portbench.check import gap_norm
from portbench.reference.model import Matmul, lane_losses


def ring_weights(n: int, straggler: bool, dtype: torch.dtype, device
                 ) -> torch.Tensor:
    """(N, N) P with out = Pᵀ·W: the ring's weights (1/3 each from three
    workers on), or the identity in a straggler round, rounded to the
    parameter dtype and returned as float32."""
    if straggler or n == 1:
        s, l, r = 1.0, 0.0, 0.0
    elif n == 2:
        s, l, r = 0.5, 0.25, 0.25
    else:
        s, l, r = 1 / 3, 1 / 3, 1 / 3
    w = torch.tensor([s, l, r]).to(dtype).to(torch.float32)
    P = torch.zeros(n, n)
    for j in range(n):
        P[j, j] += w[0]
        P[(j - 1) % n, j] += w[1]
        P[(j + 1) % n, j] += w[2]
    return P.to(device)


class RingReplay:
    """N workers' replicas, all starting from the seed's weights.

    ``fault`` plants one of the faults a run is checked against
    ("half_batch": each worker's gradient of the first half of its
    tokens; "no_exchange": no gossip)."""

    def __init__(self, cfg: dict, seed: int, n: int, device, mm: Matmul,
                 fault: Optional[str] = None, chunk: int = 1 << 24):
        self.cfg, self.seed, self.n, self.mm, self.fault = cfg, seed, n, mm, fault
        self.device, self.chunk = device, chunk
        self.dtype = inputs.dtype_of(cfg)
        self.W = {}
        for k in inputs.param_shapes(cfg):
            w0 = inputs.init_leaf(cfg, k, seed, device)
            self.W[k] = w0.unsqueeze(0).expand(n, *w0.shape).clone()
            del w0

    def w0(self, key: str) -> torch.Tensor:
        return inputs.init_leaf(self.cfg, key, self.seed, self.device)

    def step(self, tokens: torch.Tensor, eta: float, straggler: bool,
             update_norms: bool = False):
        """One step on tokens (N, B, T).  Returns the workers' mean loss and,
        with ``update_norms``, {leaf: ‖W0 − (W − η·g)‖ over all workers}
        taken before the gossip."""
        losses = []
        for i in range(self.n):
            tok = tokens[i]
            if self.fault == "half_batch":
                tok = (tok[:tok.shape[0] // 2] if tok.shape[0] > 1
                       else tok[:, :tok.shape[1] // 2])
            params = {k: w[i].detach().requires_grad_() for k, w in self.W.items()}
            loss = lane_losses({k: p[None] for k, p in params.items()},
                               tok[None], self.cfg, self.mm, remat=True)[0]
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            del params, loss
            with torch.no_grad():
                for (k, w), g in zip(self.W.items(), grads):
                    w[i] = (w[i].float() - eta * g.to(self.dtype).float()
                            ).to(self.dtype)
            del grads
        norms = self.change_norms() if update_norms else None
        if self.fault != "no_exchange":
            self._gossip(ring_weights(self.n, straggler, self.dtype,
                                      self.device))
        return sum(losses) / self.n, norms

    @torch.no_grad()
    def _gossip(self, P: torch.Tensor) -> None:
        for k, w in self.W.items():
            flat = w.view(self.n, -1)
            out = torch.empty_like(flat)
            for a in range(0, flat.shape[1], self.chunk):
                b = min(flat.shape[1], a + self.chunk)
                out[:, a:b] = (P.T @ flat[:, a:b].float()).to(self.dtype)
            self.W[k] = out.view(w.shape)
            del w, flat

    @torch.no_grad()
    def change_norms(self) -> Dict[str, float]:
        """{leaf: ‖W − W0‖ over all workers}."""
        return {k: gap_norm(w, self.w0(k)) for k, w in self.W.items()}
