"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

The port of ``repro/models/rglru.py``.  Real-Gated Linear Recurrent Unit:

    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = a^{c·r_t},  a = σ(Λ)        per-channel data-gated decay (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The recurrence is a diagonal first-order linear scan.  Serving computes it
with the ``linear_scan`` kernel; the differentiable training forward
(``apply_rglru_block(..., train_scan=True)``, which ``lm_loss`` takes)
computes it as the reference does, with ``rglru_train_scan``: log-depth
scans over chunks of 256 steps, each rematerialised when the caller asks
(the kernel has no backward, and the reference's training path never
reaches its Pallas kernel either).
Both compute the same function.  The block wraps the RG-LRU with in/out
projections, a short causal conv and a GeLU gate branch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.models.layers import const, rematerialise, weight

_C = 8.0  # Griffin's fixed gate sharpness


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) float32 recurrent state
    conv: torch.Tensor       # (B, conv_width-1, W) trailing conv inputs

    @staticmethod
    def zeros(batch: int, cfg, dtype: torch.dtype,
              device: torch.device) -> "RGLRUState":
        w = cfg.rnn_width
        return RGLRUState(
            h=torch.zeros((batch, w), dtype=torch.float32, device=device),
            conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                             device=device),
        )


class RGLRUBlock(nn.Module):
    def __init__(self, cfg, gen: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        d, w, dt = cfg.d_model, cfg.rnn_width, cfg.pdtype
        self.w_in = weight((d, w), dt, device, gen)
        self.w_gate_branch = weight((d, w), dt, device, gen)
        self.conv_kernel = weight((cfg.conv_width, w), dt, device, gen, scale=0.1)
        self.conv_bias = const((w,), 0.0, dt, device)
        self.w_a = weight((w, w), dt, device, gen, scale=0.01)
        self.b_a = const((w,), 0.0, dt, device)
        self.w_x = weight((w, w), dt, device, gen, scale=0.01)
        self.b_x = const((w,), 0.0, dt, device)
        self.lam = const((w,), 2.0, dt, device)   # a = σ(Λ) ≈ 0.88 at init
        self.w_out = weight((w, d), dt, device, gen)


def _causal_conv(x, kernel, bias, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv over T.  x: (B, T, W); kernel: (cw, W)."""
    cw = kernel.shape[0]
    T = x.shape[1]
    if carry is None:
        carry = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    out = sum(xp[:, i:i + T] * kernel[i][None, None, :] for i in range(cw))
    # a copy, so the state does not pin the whole padded input
    new_carry = xp[:, -(cw - 1):].clone() if cw > 1 else carry
    return out + bias[None, None, :], new_carry


def rglru_scan(a: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t·h_{t-1} + x_t, h_0 = 0, through
    the ``linear_scan`` kernel (serving).  a, x_in: (B, T, W) float32."""
    return linear_scan(a, x_in)


def _log_depth_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + x_t over axis 1 in ⌈log2 T⌉ Hillis–Steele steps:
    at offset d every position t ≥ d folds in the prefix ending at t − d.
    The prefix is shifted in by padding (x with 0, a with 1), so positions
    t < d keep x_t + a_t·0 and a_t·1, exactly their values."""
    T = a.shape[1]
    d = 1
    while d < T:
        x = x + a * F.pad(x[:, :-d], (0, 0, d, 0))
        if 2 * d < T:
            a = a * F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        d *= 2
    return x


def _scan_chunk(ac: torch.Tensor, xc: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """One chunk's states, the carried boundary state h0 folded into every
    step as (∏_{s≤t} a_s)·h0, the product as exp(cumsum(log(clip(a,
    1e-30)))) (the reference's ``one_chunk``)."""
    h = _log_depth_scan(ac, xc)
    cum = torch.exp(torch.cumsum(torch.log(torch.clamp(ac, min=1e-30)), dim=1))
    return h + cum * h0[:, None, :]


def rglru_train_scan(a: torch.Tensor, x_in: torch.Tensor,
                     chunk: int = 256, remat: bool = False) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + x_t, h_0 = 0, differentiable: the reference's
    training ``rglru_scan``.  One log-depth scan over the whole sequence
    when T ≤ chunk or T % chunk ≠ 0; else chunk after chunk, each a
    log-depth scan carrying only the boundary state.  With ``remat`` each
    chunk runs under ``rematerialise`` (the reference always checkpoints
    it), so the backward keeps one chunk's tree at a time; without it the
    values are the same and ``torch.func`` can differentiate it.  a, x_in:
    (B, T, W) float32."""
    B, T, W = a.shape
    if T <= chunk or T % chunk:
        return _log_depth_scan(a, x_in)
    h0 = a.new_zeros((B, W))
    run = ((lambda *args: rematerialise(_scan_chunk, *args)) if remat
           else _scan_chunk)
    hs = []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        h = run(a[:, sl], x_in[:, sl], h0)
        hs.append(h)
        h0 = h[:, -1]
    return torch.cat(hs, dim=1)


def apply_rglru_block(p: RGLRUBlock, cfg, x: torch.Tensor,
                      state: Optional[RGLRUState] = None,
                      train_scan: bool = False, remat: bool = False):
    """x: (B, T, D) -> (out, new_state).  ``train_scan`` runs the
    recurrence through ``rglru_train_scan`` (differentiable; its chunks
    rematerialised with ``remat``) instead of the ``linear_scan`` kernel."""
    f32 = torch.float32
    gate = F.gelu((x @ p.w_gate_branch).to(f32), approximate="tanh")
    u = x @ p.w_in
    u, conv_carry = _causal_conv(u, p.conv_kernel, p.conv_bias,
                                 state.conv if state is not None else None)
    u32 = u.to(f32)
    r = torch.sigmoid((u @ p.w_a).to(f32) + p.b_a.to(f32))
    i = torch.sigmoid((u @ p.w_x).to(f32) + p.b_x.to(f32))
    log_a = _C * r * F.logsigmoid(p.lam.to(f32))
    a = torch.exp(log_a)                             # (B, T, W) in (0, 1)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * (i * u32)
    if x.shape[1] == 1 and state is not None:
        h = (a[:, 0] * state.h + gated_in[:, 0])[:, None]
    else:
        h = (rglru_train_scan(a, gated_in, remat=remat) if train_scan
             else rglru_scan(a, gated_in))
        if state is not None:  # prefill continuing from a state
            # fold h0 into every step: h_t += (prod_{s<=t} a_s)·h0
            cum = torch.exp(torch.cumsum(log_a, dim=1))
            h = h + cum * state.h[:, None, :]
    y = (h * gate).to(x.dtype)
    return y @ p.w_out, RGLRUState(h=h[:, -1].clone(), conv=conv_carry)
