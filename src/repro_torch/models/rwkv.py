"""RWKV6 ("Finch") blocks -- attention-free with data-dependent decay
[arXiv:2404.05892].  The port of ``repro/models/rwkv.py``.

Per head (dims K = V = head size), with receptance r, key k, value v, decay
w and bonus u, the recurrence is

    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The decay w_t = exp(-exp(w0 + B·tanh(A·x_t))) is data-dependent.  Prefill
evaluates the recurrence in chunks (``chunked_rwkv``: the intra-chunk
products of every chunk at once, then the state carried from chunk to
chunk); decode is the O(1) single-step update (``rwkv_step``).  The
recurrence runs in float32, as the reference computes it, in PyTorch ops:
the reference's is a ``jax.lax.scan``, not a Pallas kernel.

Ragged lengths.  The reference's ``apply_time_mix`` takes chunks of 64 when
64 divides T, one chunk of T when T < 64, and chunks of one token
otherwise -- a T-step scan.  The port's takes full 64-token chunks and one
chunk of the remainder, carrying S between them.  Both group the same sums;
they agree to float32 rounding while each chunk's cumulative decay
prod_{s<=t} w_s stays above the 1e-20 floor that ``chunked_rwkv`` puts
under it (at the seeded initialisation, w ≈ 0.87, a 64-token chunk's decay
is ≈ 2e-4).  ``chunked_rwkv(..., chunk)`` itself keeps the reference's
semantics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RMSNorm, const, rmsnorm, weight

CHUNK = 64   # the reference's chunk length


class RWKVState(NamedTuple):
    """Decode-time state: the last token's inputs to the two shifts and the
    per-head matrix state."""
    shift_tm: torch.Tensor   # (B, D) previous token's input to time-mix
    shift_cm: torch.Tensor   # (B, D) previous token's input to channel-mix
    S: torch.Tensor          # (B, H, K, V) float32 matrix state

    @staticmethod
    def zeros(batch: int, cfg, dtype: torch.dtype,
              device: torch.device) -> "RWKVState":
        K = cfg.rwkv_head_dim
        H = cfg.d_model // K
        return RWKVState(
            shift_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            shift_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            S=torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
        )


class TimeMix(nn.Module):
    """The reference's ``init_time_mix`` leaves in (in, out) layout, each
    with the leading axes ``lead`` (the layer axis of a stack)."""

    def __init__(self, cfg, gen: Optional[torch.Generator],
                 device: torch.device, lead: Tuple[int, ...] = ()):
        super().__init__()
        d, K, dt = cfg.d_model, cfg.rwkv_head_dim, cfg.pdtype
        H = d // K
        lora = max(32, d // 32)
        lead = tuple(lead)
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, const(lead + (d,), 0.5, dt, device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, weight((d, d), dt, device, gen, lead=lead))
        # data-dependent decay: w_t = exp(-exp(w0 + B·tanh(A·x)))
        self.decay_w0 = const(lead + (d,), -2.0, dt, device)
        self.decay_A = weight((d, lora), dt, device, gen, scale=0.01, lead=lead)
        self.decay_B = weight((lora, d), dt, device, gen, scale=0.01, lead=lead)
        self.bonus_u = weight((H, K), dt, device, gen, scale=0.05, lead=lead)
        self.out_norm = RMSNorm(d, dt, device, lead)


class ChannelMix(nn.Module):
    """The reference's ``init_channel_mix`` leaves."""

    def __init__(self, cfg, gen: Optional[torch.Generator],
                 device: torch.device, lead: Tuple[int, ...] = ()):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
        lead = tuple(lead)
        self.mu_k = const(lead + (d,), 0.5, dt, device)
        self.mu_r = const(lead + (d,), 0.5, dt, device)
        self.w_k = weight((d, f), dt, device, gen, lead=lead)
        self.w_v = weight((f, d), dt, device, gen, lead=lead)
        self.w_r = weight((d, d), dt, device, gen, lead=lead)


def _token_shift(x: torch.Tensor,
                 x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} per position; position 0 sees ``x_prev_last`` (the decode
    carry) or 0."""
    first = (torch.zeros_like(x[:, :1]) if x_prev_last is None
             else x_prev_last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(mu: torch.Tensor, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def chunked_rwkv(r, k, v, w, u, S0, chunk: int = CHUNK):
    """Chunked parallel evaluation of the RWKV6 recurrence.

    r/k/w: (B, H, T, K); v: (B, H, T, V); u: (H, K); S0: (B, H, K, V);
    ``chunk`` must divide T.  Returns (y (B, H, T, V), S_T), all in
    float32.  Each chunk's terms that do not read the state (the
    intra-chunk products, the bonus, the chunk's own contribution to the
    state) are computed for every chunk at once; the state is then carried
    from chunk to chunk, and each chunk's cross term reads the state it
    starts from.
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        raise ValueError(f"chunked_rwkv: chunk {chunk} does not divide T={T}")
    n = T // chunk
    f32 = torch.float32
    rc, kc, wc = (a.to(f32).reshape(B, H, n, chunk, K) for a in (r, k, w))
    vc = v.to(f32).reshape(B, H, n, chunk, V)
    logw = torch.log(torch.clamp(wc, 1e-6, 1.0))
    logA = torch.cumsum(logw, dim=3)                 # inclusive cumulative log-decay
    A = torch.exp(logA)                              # prod_{s<=t} w_s
    Aprev = torch.exp(logA - logw)                   # prod_{s<t}  w_s
    kscaled = kc / torch.clamp(A, min=1e-20)         # k_s / A_s
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device),
                     diagonal=-1)

    rA = rc * Aprev                                  # (B,H,n,c,K)
    # intra-chunk: Σ_{s<t} ((r_t⊙A_{t-1})·(k_s/A_s)) v_s
    qk = torch.einsum("bhntk,bhnsk->bhnts", rA, kscaled) * tri
    y_intra = torch.einsum("bhnts,bhnsv->bhntv", qk, vc)
    # current-token bonus: u·(r_t·k_t) v_t
    bonus = torch.einsum("bhntk,bhntk->bhnt", rc * u.to(f32)[None, :, None, None, :], kc)
    y_self = bonus[..., None] * vc
    # carry: S' = diag(A_c) S + Σ_s diag(A_c/A_s) k_s v_sᵀ
    Ac = A[:, :, :, -1]                              # (B,H,n,K)
    kv = torch.einsum("bhnsk,bhnsv->bhnkv", kscaled * Ac[:, :, :, None, :], vc)
    S = S0.to(f32)
    starts = []
    for ci in range(n):
        starts.append(S)
        S = Ac[:, :, ci, :, None] * S + kv[:, :, ci]
    # cross-chunk contribution: (r_t ⊙ A_{t-1})ᵀ S_start
    y_cross = torch.einsum("bhntk,bhnkv->bhntv", rA, torch.stack(starts, dim=2))
    y = y_cross + y_intra + y_self
    return y.reshape(B, H, T, V), S


def rwkv_step(r, k, v, w, u, S):
    """Single decode step: r/k/w (B, H, K); v (B, H, V); S (B, H, K, V).
    Returns (y (B, H, V), S') in float32."""
    f32 = torch.float32
    r, k, v, w = (a.to(f32) for a in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]           # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", r, S + u.to(f32)[None, :, :, None] * kv)
    return y, w[..., None] * S + kv


def _decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    """exp(-exp(w0 + B·tanh(A·x))) in float32, after products in x's dtype."""
    dd = torch.tanh(xw @ p.decay_A) @ p.decay_B
    return torch.exp(-torch.exp(p.decay_w0.to(torch.float32)
                                + dd.to(torch.float32)))


def _recurrence(r, k, v, w, u, S0, chunk: int):
    """The sequence recurrence as full ``chunk``-token chunks, then one
    chunk of the remainder, the state carried across (see the module
    docstring for how this relates to the reference's grouping)."""
    T = r.shape[2]
    full = T - T % chunk
    ys, S = [], S0
    for a, b, c in ((0, full, chunk), (full, T, T - full)):
        if b > a:
            y, S = chunked_rwkv(r[:, :, a:b], k[:, :, a:b], v[:, :, a:b],
                                w[:, :, a:b], u, S, chunk=c)
            ys.append(y)
    return torch.cat(ys, dim=2) if len(ys) > 1 else ys[0], S


def apply_time_mix(p: TimeMix, cfg, x: torch.Tensor,
                   state: Optional[RWKVState] = None, chunk: int = CHUNK):
    """Time-mix over a sequence (prefill) or one step (decode).

    x: (B, T, D).  Returns (out, new_S, last_x): new_S and last_x (a copy
    of x[:, -1], so the state does not pin the sequence) feed decode.

    A ragged T > 64 matches the reference's T-step scan only while every
    64-token chunk's cumulative decay stays above 1e-20 (module docstring).
    The seeded weights do; a trained checkpoint must be checked against
    this before it is served, since faster decays (w ≈ 0.3 floors a chunk
    from its 37th token) make the outputs part by O(|y|).
    """
    B, T, D = x.shape
    K = cfg.rwkv_head_dim
    H = D // K
    prev = _token_shift(x, state.shift_tm if state is not None else None)
    xr, xk, xv, xg, xw = (_lerp(mu, x, prev) for mu in
                          (p.mu_r, p.mu_k, p.mu_v, p.mu_g, p.mu_w))

    def heads(t):
        return t.reshape(B, T, H, K).transpose(1, 2)

    r, k, v = heads(xr @ p.w_r), heads(xk @ p.w_k), heads(xv @ p.w_v)
    g = F.silu((xg @ p.w_g).to(torch.float32)).to(x.dtype)
    w = heads(_decay(p, xw))
    u = p.bonus_u.to(torch.float32)
    S0 = (state.S if state is not None else
          torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device))
    if T == 1:
        y, S_new = rwkv_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u, S0)
        y = y[:, :, None]                            # (B,H,1,V)
    else:
        y, S_new = _recurrence(r, k, v, w, u, S0, chunk)
    y = y.transpose(1, 2).reshape(B, T, D).to(x.dtype)
    y = rmsnorm(p.out_norm, y, cfg.norm_eps) * g
    return y @ p.w_o, S_new, x[:, -1].clone()


def apply_channel_mix(p: ChannelMix, x: torch.Tensor,
                      state_prev: Optional[torch.Tensor] = None):
    """Channel-mix; returns (out, last_x), last_x a copy of x[:, -1]."""
    prev = _token_shift(x, state_prev)
    xk = _lerp(p.mu_k, x, prev)
    xr = _lerp(p.mu_r, x, prev)
    kk = torch.square(torch.relu((xk @ p.w_k).to(torch.float32))).to(x.dtype)
    rr = torch.sigmoid((xr @ p.w_r).to(torch.float32)).to(x.dtype)
    return rr * (kk @ p.w_v), x[:, -1].clone()
