"""Mixture-of-Experts FFN of the port (``repro/models/moe.py``): grok-1
(8 experts, top-2) and arctic (128 experts, top-2, plus a dense residual
MLP).

Switch-style capacity dispatch, as the reference: each token's top-k
experts come from a float32 softmax of the router's logits; a (token,
choice) pair takes the next free slot of its expert's capacity buffer, in
the token-major order of the (N·k) pairs, and a pair past the capacity is
dropped (gate 0).  ``cfg.moe_groups = G > 1`` splits the tokens into G
dispatch groups (GShard) when N divides evenly and each group holds at
least one token per expert; each group routes and fills its own buffers,
and the aux loss is the mean over the groups.

The dispatch needs no atomics and no host sync: the kept rows are copied to
their slots of one (E·G·C + 1, d) buffer and the dropped rows to its last
row, which is sliced off, giving the reference's scatter-add (``mode=
"drop"``, zeros added at slot C − 1) exactly.  The buffer is laid out
expert-major, (E, G·C, d), so the experts' SwiGLU runs as three batched
products over E that read each expert's weights once for all groups; the
products accumulate in float32 and return float32, as the reference's
``einsum(..., preferred_element_type=float32)``, and ``silu(g)·u`` is taken
in float32 before the cast.  These products are library matmuls: the
reference computes them outside any Pallas kernel.

The expert leaves are (E, d, f), so the reference's ``_dense_init`` draws
them at scale 1/√E (its fan-in is the leading axis); the port keeps that.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L


class MoE(nn.Module):
    """The MoE FFN's weights: ``router`` (d, E), ``w_gate``/``w_up``
    (E, d, f), ``w_down`` (E, f, d) and, for arctic, ``dense_residual`` (a
    SwiGLU MLP); each with the leading ``lead`` axes of a layer stack.
    The expert leaves are drawn one (d, f) slice at a time."""

    def __init__(self, cfg, gen: Optional[torch.Generator],
                 device: torch.device, lead: Tuple[int, ...] = ()):
        super().__init__()
        d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype
        self.router = L.weight((d, E), dt, device, gen, scale=0.02, lead=lead)
        self.w_gate = L.weight((E, d, f), dt, device, gen, lead=lead, sliced=True)
        self.w_up = L.weight((E, d, f), dt, device, gen, lead=lead, sliced=True)
        self.w_down = L.weight((E, f, d), dt, device, gen, lead=lead, sliced=True)
        if cfg.dense_residual_ff:
            self.dense_residual = L.MLP(d, cfg.dense_residual_ff, dt, device,
                                        gen, lead)


def init_moe(cfg, gen: Optional[torch.Generator],
             device: DeviceLike = "cuda") -> MoE:
    """One MoE FFN on ``device``, drawn from ``gen`` with the reference's
    initialisers (uninitialised when ``gen`` is None, for a load)."""
    return MoE(cfg, gen, resolve_device(device))


def _top_k_gating(logits: torch.Tensor, top_k: int):
    """logits (..., N, E) -> (gates (..., N, k) renormalised, expert_idx
    (..., N, k), aux load-balance loss (...,)), all float32 but the indices.

    The top k are taken by a stable descending sort, so equal
    probabilities go to the lower expert index first, as ``jax.lax.top_k``
    (``torch.topk`` promises no order among ties, and bf16 logits tie)."""
    N, E = logits.shape[-2:]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :top_k], idx[..., :top_k]
    gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch/GShard load-balance loss: E · Σ_e fraction_e · mean_prob_e
    me = probs.mean(dim=-2)                                    # (..., E)
    picks = expert_idx.flatten(-2)
    ce = torch.zeros_like(me).scatter_add_(
        -1, picks, torch.full(picks.shape, 1.0 / (N * top_k),
                              dtype=torch.float32, device=picks.device))
    return gates, expert_idx, E * (me * ce).sum(-1)


def apply_moe(p, cfg, x: torch.Tensor, *,
              capacity_factor: Optional[float] = None):
    """x: (B, T, d) -> (out (B, T, d), aux loss, a float32 scalar).

    ``p`` is an ``MoE`` or any object with the same attributes (one layer's
    view of a layer-stacked flat dict)."""
    B, T, d = x.shape
    N = B * T
    G = max(1, cfg.moe_groups)
    if not (G > 1 and N % G == 0 and N // G >= cfg.n_experts):
        G = 1
    out, aux = _moe_tokens(p, cfg, x.reshape(G, N // G, d), capacity_factor)
    return out.reshape(B, T, d), aux.mean()


def _moe_tokens(p, cfg, xt: torch.Tensor,
                capacity_factor: Optional[float] = None):
    """Dispatch, experts and combine for G groups of N tokens, xt (G, N, d);
    returns (out (G, N, d), aux (G,))."""
    G, N, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = xt @ p.router                # (G, N, E), float32 sums, xt's dtype
    gates, expert_idx, aux = _top_k_gating(logits, k)
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    C = max(4, int(cf * k * N / E))

    # each (token, choice)'s slot: earlier pairs routed to the same expert,
    # counted over the token-major (N·k) flattening.  The one-hot is laid out
    # (G, E, N·k) so the count runs along the innermost axis: along an outer
    # axis PyTorch's CUDA scan gives each of the E columns one thread, which
    # walks the N·k pairs one by one
    pairs = expert_idx.reshape(G, 1, N * k)
    hot = pairs == torch.arange(E, device=xt.device)[None, :, None]
    pos = (hot.cumsum(dim=2).gather(1, pairs) - 1).reshape(G, N, k)
    keep = pos < C
    gates = gates * keep
    safe_pos = torch.where(keep, pos, C - 1)

    # dispatch: buffer row (e·G + g)·C + slot; dropped pairs to a spare row
    base = (expert_idx * G + torch.arange(G, device=xt.device)[:, None, None]) * C
    rows = torch.where(keep, base + pos, E * G * C).reshape(-1)
    src = xt[:, :, None, :].expand(G, N, k, d).reshape(G * N * k, d)
    buf = xt.new_zeros((E * G * C + 1, d)).index_copy(0, rows, src)
    expert_in = buf[:-1].view(E, G * C, d)

    # expert FFN (SwiGLU) batched over E, float32 products
    h = F.silu(L.bmm_f32(expert_in, p.w_gate), inplace=True)
    h = h.mul_(L.bmm_f32(expert_in, p.w_up)).to(xt.dtype)
    expert_out = L.bmm_f32(h, p.w_down).to(xt.dtype).view(E * G * C, d)

    # combine: each pair's expert output (slot C − 1 for a dropped pair, its
    # gate 0), weighted and summed over the k choices in xt's dtype
    gathered = expert_out[(base + safe_pos).reshape(-1)].view(G, N, k, d)
    out = (gathered * gates.to(xt.dtype)[..., None]).sum(dim=2)
    if cfg.dense_residual_ff:
        out = out + L.apply_mlp(p.dense_residual, xt)
    return out, aux
