"""The two precision choices of the port's tensor-core kernels, on the CPU.

The CUDA kernels run only on the card; these tests make their tolerance
argument where there is none, by emulating each kernel's arithmetic on the
same inputs (drawn with NumPy) and holding it against the JAX package's
oracles at the tolerances the card is held to:

* ``gossip_mix`` multiplies float32 operands as three TF32 products
  (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each operand split into
  hi = round_tf32(x) and lo = round_tf32(x − hi)) accumulated in float32.
  That stays within float32 atol 2e-5 / rtol 1e-4 of the reference; one
  TF32 pass does not, which is why the split is needed.
* ``masked_gossip`` runs the same body as one reduction of depth 2·Kp over
  [−Q; P] and [G; W] stacked along k, each half zero-padded from N to Kp
  on its own, every 32-row slab summed into a fresh float32 partial that
  is added to the total: within the same bound of the reference.
* ``sparse_gossip`` (wider rows) runs that body with the W half gathered,
  row k = W[gidx[k]] of a larger carry, over A lanes: within the same
  bound of the reference's ``sparse_gossip_ref``, on merged rows too.
* ``swa_attention`` (bfloat16) rounds the probabilities to bfloat16 before
  the PV product.  An online softmax over 64-key tiles in float32 with that
  rounding stays within ``chip_smoke.py``'s bf16 bound for the kernel
  (atol 5e-3 / rtol 1e-2) of the reference.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_mix.ref import gossip_mix_ref as jax_mix_ref
from repro.kernels.gossip_mix.ref import masked_gossip_ref as jax_masked_ref
from repro.kernels.sparse_gossip.ref import sparse_gossip_ref as jax_sparse_ref
from repro.kernels.swa_attention.ref import swa_attention_ref as jax_swa_ref

FP32_TOL = dict(atol=2e-5, rtol=1e-4)
SWA_BF16_TOL = dict(atol=5e-3, rtol=1e-2)
MMA_K = 8          # depth of one TF32 MMA step (mma.sync m16n8k8, wgmma k8)
SLAB = 32          # values of k per float32 partial sum of the wgmma body
KEY_TILE = 64      # keys per tile of the bf16 attention kernel

_jit_swa_ref = jax.jit(jax_swa_ref, static_argnames=("window", "n_groups"))


def _round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does: add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_parts(x: np.ndarray):
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


def _tf32_mix(W: np.ndarray, P: np.ndarray, terms: int) -> np.ndarray:
    """Pᵀ·W as the kernel's MMAs compute it: TF32 operands, products exact
    (11 × 11 bits fit float32), sums kept in float32 after every k-step."""
    A_hi, A_lo = _tf32_parts(P.T)
    B_hi, B_lo = _tf32_parts(W)
    pairs = ([(A_lo, B_hi), (A_hi, B_lo)] if terms == 3 else []) + [(A_hi, B_hi)]
    acc = np.zeros((P.shape[1], W.shape[1]), dtype=np.float32)
    for k0 in range(0, P.shape[0], MMA_K):
        ks = slice(k0, k0 + MMA_K)
        for A, B in pairs:
            step = A[:, ks].astype(np.float64) @ B[ks].astype(np.float64)
            acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def _tf32_masked_mix(W, G, P, Q, terms: int, gidx=None) -> np.ndarray:
    """Pᵀ·W − Qᵀ·G as the shared wgmma body computes it: B = [−Q; P] and
    A = [G; W] stacked along k, each half zero-padded from N to Kp on its
    own; per slab of 32 values of k a fresh float32 partial sum, fed the
    small terms (a_lo·b_hi, a_hi·b_lo) of the slab's four k-steps before
    their a_hi·b_hi; the partial added to the float32 total.  With
    ``gidx`` the W half's row k is W[gidx[k]], clamped into W's rows, as
    sparse_gossip's body copies it (k keeps its order)."""
    if gidx is not None:
        W = W[np.clip(gidx, 0, W.shape[0] - 1)]
    n, d = W.shape
    kp = -(-n // SLAB) * SLAB
    B = np.zeros((2 * kp, n), dtype=np.float32)
    A = np.zeros((2 * kp, d), dtype=np.float32)
    B[:n], B[kp:kp + n] = -Q, P
    A[:n], A[kp:kp + n] = G, W
    (A_hi, A_lo), (B_hi, B_lo) = _tf32_parts(A), _tf32_parts(B)
    total = np.zeros((n, d), dtype=np.float32)
    for s0 in range(0, 2 * kp, SLAB):
        part = np.zeros((n, d), dtype=np.float32)
        steps = [slice(k, k + MMA_K) for k in range(s0, s0 + SLAB, MMA_K)]
        order = ([x for ks in steps
                  for x in ((A_lo, B_hi, ks), (A_hi, B_lo, ks))]
                 if terms == 3 else []) + [(A_hi, B_hi, ks) for ks in steps]
        for a, b, ks in order:
            step = b[ks].astype(np.float64).T @ a[ks].astype(np.float64)
            part = (part + step.astype(np.float32)).astype(np.float32)
        total = (total + part).astype(np.float32)
    return total


def test_round_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 3.0e-3], dtype=np.float32)
    r = _round_tf32(x)
    assert r[0] == 1.0 and r[1] == np.float32(1.0 + 2.0 ** -10)
    assert r[2] == np.float32(1.0 + 2.0 ** -10)     # a tie rounds away from 0
    assert r[3] == 1.0
    assert r[4] == np.float32(-(1.0 + 2.0 ** -10))
    assert (r.view(np.uint32) & np.uint32(0x1FFF)).max() == 0
    assert abs(float(r[5]) - 3.0e-3) <= 2.0 ** -11 * 3.0e-3
    # hi + lo carries x to ~2^-22 relative
    hi, lo = _tf32_parts(x)
    np.testing.assert_allclose(hi.astype(np.float64) + lo, x, rtol=2.0 ** -21)


@pytest.mark.parametrize("n,d", [(8, 4097), (64, 1000), (100, 511)])
def test_three_tf32_products_hold_float32_parity(n, d):
    rng = np.random.default_rng(10 * n + d)
    P = rng.random((n, n)).astype(np.float32) + np.eye(n, dtype=np.float32)
    P = (P / P.sum(axis=1, keepdims=True)).astype(np.float32)
    W = rng.normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(jax_mix_ref(jnp.asarray(W), jnp.asarray(P)))
    three = _tf32_mix(W, P, terms=3)
    np.testing.assert_allclose(three, ref, **FP32_TOL)
    assert np.abs(three - ref).max() < 2e-6
    # one TF32 pass misses the float32 bound: the split is needed
    one = _tf32_mix(W, P, terms=1)
    assert not np.allclose(one, ref, **FP32_TOL)
    assert np.abs(one - ref).max() > 5 * np.abs(three - ref).max()


@pytest.mark.parametrize("n,d,stochastic", [(8, 300, True), (65, 129, True),
                                            (256, 40, True), (256, 40, False)])
def test_masked_three_tf32_products_hold_float32_parity(n, d, stochastic):
    """The masked form on the stacked operands, N not a multiple of 32
    included, against the reference; with an unnormalised P (outputs of
    order 10) also within the float32 bound of the float64 product."""
    rng = np.random.default_rng(n + d + stochastic)
    P = rng.random((n, n)).astype(np.float32)
    if stochastic:
        P = P + np.eye(n, dtype=np.float32)
        P = (P / P.sum(axis=1, keepdims=True)).astype(np.float32)
    # η·mask of a dense event, or a Q of scale 0.1 beside the unnormalised P
    mask = ((rng.random(n) < 0.5) * 0.2 if stochastic
            else rng.random(n) * 0.1).astype(np.float32)
    Q = (mask[:, None] * P).astype(np.float32)
    W = rng.normal(size=(n, d)).astype(np.float32)
    G = rng.normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(jax_masked_ref(*(jnp.asarray(x) for x in (W, G, P, mask))))
    three = _tf32_masked_mix(W, G, P, Q, terms=3)
    np.testing.assert_allclose(three, ref, **FP32_TOL)
    exact = P.T.astype(np.float64) @ W - Q.T.astype(np.float64) @ G
    assert np.abs(three - exact).max() <= FP32_TOL["atol"]
    # one TF32 pass misses the float32 bound here too
    one = _tf32_masked_mix(W, G, P, Q, terms=1)
    assert not np.allclose(one, ref, **FP32_TOL)


def _merged_lanes(rng, a: int, n_carry: int):
    """A merged row as merge_event_groups packs it: cliques of 3-8 distinct
    workers of the carry, one after another from lane 0 while they fit,
    then -1 lanes; and the block-diagonal mask of its P_sub."""
    workers = np.full(a, -1, dtype=np.int32)
    clique = np.full(a, -1)
    o = c = 0
    while True:
        m = int(rng.integers(3, 9))
        if o + m > a:
            break
        clique[o:o + m] = c
        o, c = o + m, c + 1
    workers[:o] = rng.permutation(n_carry)[:o]
    block = (clique[:, None] == clique[None, :]) & (clique[:, None] >= 0)
    return workers, block.astype(np.float32)


@pytest.mark.parametrize("a,kind", [(16, "merged"), (33, "merged"),
                                    (64, "merged"), (33, "full"),
                                    (64, "full")])
def test_gathered_three_tf32_products_hold_float32_parity(a, kind):
    """sparse_gossip's wgmma body: A lanes gathered from a carry of 2A + 5
    rows, on a merged row (block-diagonal stochastic P_sub, -1 lanes at the
    end, their rows and columns zero) or on all lanes with an unnormalised
    P (outputs of order 10, then also within the float32 bound of the
    float64 product), against the reference's oracle."""
    rng = np.random.default_rng(7 * a + len(kind))
    n_carry, d = 2 * a + 5, 300
    W = rng.normal(size=(n_carry, d)).astype(np.float32)
    G = rng.normal(size=(a, d)).astype(np.float32)
    if kind == "merged":
        workers, block = _merged_lanes(rng, a, n_carry)
        P = (rng.random((a, a)) + np.eye(a)) * block
        P = P / np.maximum(P.sum(axis=1, keepdims=True), 1e-30)
        mask = (rng.random(a) < 0.7) * 0.2 * (workers >= 0)
    else:
        workers = rng.permutation(n_carry)[:a].astype(np.int32)
        P = rng.random((a, a))
        mask = rng.random(a) * 0.1
    P, mask = P.astype(np.float32), mask.astype(np.float32)
    Q = (mask[:, None] * P).astype(np.float32)
    gidx = np.where(workers >= 0, workers, 0)
    ref = np.asarray(jax_sparse_ref(*(jnp.asarray(x) for x in
                                      (W, G, P, Q, workers))))
    three = _tf32_masked_mix(W, G, P, Q, terms=3, gidx=gidx)
    np.testing.assert_allclose(three, ref, **FP32_TOL)
    assert not three[workers < 0].any()
    if kind == "full":
        exact = P.T.astype(np.float64) @ W[gidx] - Q.T.astype(np.float64) @ G
        assert np.abs(exact).max() > 10
        assert np.abs(three - exact).max() <= FP32_TOL["atol"]


def _bf16(x: np.ndarray) -> torch.Tensor:
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32)


def _bf16_p_attention(q, k, v, window: int, n_groups: int) -> torch.Tensor:
    """The bf16 kernel's arithmetic in float32: scores scaled in log2 units,
    an online softmax over 64-key tiles from the diagonal back, masked
    scores at -1e30, P rounded to bfloat16 before the PV product, the
    normaliser clamped at 1e-30, the output rounded to bfloat16."""
    BH, T, dh = q.shape
    kf = torch.repeat_interleave(k, n_groups, dim=0)
    vf = torch.repeat_interleave(v, n_groups, dim=0)
    scale = np.float32(1.0 / math.sqrt(dh)) * np.float32(1.4426950408889634)
    rows = torch.arange(T)[:, None]
    m = torch.full((BH, T, 1), -1e30)
    l = torch.zeros((BH, T, 1))
    o = torch.zeros((BH, T, dh))
    for k0 in reversed(range(0, T, KEY_TILE)):
        keys = torch.arange(k0, min(k0 + KEY_TILE, T))[None, :]
        keep = (keys <= rows) & (keys > rows - window)
        s = torch.einsum("htd,hsd->hts", q, kf[:, keys[0]]) * float(scale)
        s = s.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.where(keep, torch.exp2(s - m_new), torch.zeros(()))
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("hts,hsd->htd",
                                    p.to(torch.bfloat16).to(torch.float32),
                                    vf[:, keys[0]])
        m = m_new
    return (o / l.clamp_min(1e-30)).to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("dh", [64, 256])
@pytest.mark.parametrize("T", [1, 100, 257])
def test_bf16_probabilities_stay_in_the_swa_bound(T, dh):
    rng = np.random.default_rng(T + dh)
    H, KV = 4, 1
    q, k, v = (_bf16(rng.normal(size=(n, T, dh)).astype(np.float32))
               for n in (H, KV, KV))
    for window in (1, 64, T + 1):
        out = _bf16_p_attention(q, k, v, window, H // KV)
        ref = np.asarray(_jit_swa_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                      window=window, n_groups=H // KV))
        assert np.isfinite(out.numpy()).all()
        torch.testing.assert_close(out, torch.tensor(ref), **SWA_BF16_TOL)
