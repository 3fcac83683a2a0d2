"""The port's kernels against the JAX package's, on the CPU.

Inputs are drawn once with NumPy and fed to both packages.  On CPU tensors
the port's wrappers run their plain PyTorch versions (the CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them against the same plain
versions); those are held here against the reference's ``ref.py`` oracles
and against its Pallas ops run in interpret mode.  Tolerances are
``tests/test_kernels.py:_tol``'s: float32 atol 2e-5 / rtol 1e-4 (sums in a
different order), bfloat16 2e-2 (one rounding of the output).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_mix import ops as jax_gossip_ops
from repro.kernels.gossip_mix.ref import masked_gossip_ref as jax_masked_ref
from repro.kernels.gossip_mix.ref import (
    gossip_mix_batched_ref as jax_mix_batched_ref,
    gossip_mix_ref as jax_mix_ref)
from repro.kernels.sparse_gossip import ops as jax_sparse_ops
from repro.kernels.sparse_gossip.ref import (
    sparse_gossip_apply_ref as jax_apply_ref,
    sparse_gossip_ref as jax_sparse_ref,
    sparse_scatter_rows_ref as jax_scatter_ref)
from repro.kernels.linear_scan.ref import linear_scan_ref as jax_scan_ref
from repro.kernels.swa_attention import ops as jax_swa_ops
from repro.kernels.swa_attention.ref import swa_attention_ref as jax_swa_ref
from repro.models.rglru import rglru_scan as jax_rglru_scan
from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import ops as gossip_ops
from repro_torch.kernels.gossip_mix.ref import (gossip_mix_batched_ref,
                                               gossip_mix_ref,
                                               masked_gossip_ref)
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.sparse_gossip import ops as sparse_ops
from repro_torch.kernels.sparse_gossip.ref import (sparse_gossip_apply_ref,
                                                  sparse_gossip_ref,
                                                  sparse_scatter_rows_ref)
from repro_torch.kernels.swa_attention import ops as swa_ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(n, d) for n in (3, 8, 16) for d in (7, 512, 1000)]


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=2e-5, rtol=1e-4))


def _both(x, name):
    """One NumPy array as a (jax, torch) pair of the named dtype."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, dtype=jdt), torch.as_tensor(x).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, dtype=jnp.float32))


def _stochastic(rng, n):
    P = rng.random((n, n)).astype(np.float32) + np.eye(n, dtype=np.float32)
    return (P / P.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d", SHAPES)
def test_masked_gossip_matches_reference(n, d, dtype):
    rng = np.random.default_rng(100 * n + d)
    W = rng.normal(size=(n, d)).astype(np.float32)
    G = rng.normal(size=(n, d)).astype(np.float32)
    P = _stochastic(rng, n)
    mask = (rng.random(n) < 0.6).astype(np.float32) * np.float32(0.2)
    (jW, tW), (jG, tG) = _both(W, dtype), _both(G, dtype)
    (jP, tP), (jm, tm) = _both(P, dtype), _both(mask, dtype)
    jax_ref = jax_masked_ref(jW, jG, jP, jm)
    jax_ops = jax_gossip_ops.masked_gossip_mix(jW, jG, jP, jm, interpret=True)
    port_ref = masked_gossip_ref(tW, tG, tP, tm)
    port_ops = gossip_ops.masked_gossip_mix(tW, tG, tP, tm)
    assert port_ops.dtype == tW.dtype and port_ops.shape == (n, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(port_ref), _f32(jax_ref), **tol)
    np.testing.assert_allclose(_f32(port_ops), _f32(jax_ops), **tol)
    np.testing.assert_allclose(_f32(port_ops), _f32(jax_ref), **tol)


def test_masked_gossip_multidim_leaf_keeps_its_shape():
    rng = np.random.default_rng(7)
    W = rng.normal(size=(8, 3, 5)).astype(np.float32)
    G = rng.normal(size=(8, 3, 5)).astype(np.float32)
    P = _stochastic(rng, 8)
    m = np.full(8, 0.1, dtype=np.float32)
    out = gossip_ops.masked_gossip_mix(*(torch.as_tensor(x) for x in (W, G, P, m)))
    ref = jax_masked_ref(*(jnp.asarray(x.reshape(8, -1)) if x.ndim == 3
                           else jnp.asarray(x) for x in (W, G, P, m)))
    assert out.shape == (8, 3, 5)
    np.testing.assert_allclose(out.numpy().reshape(8, -1), np.asarray(ref),
                               **_tol("float32"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d", SHAPES)
def test_gossip_mix_matches_reference(n, d, dtype):
    rng = np.random.default_rng(100 * n + d + 1)
    W = rng.normal(size=(n, d)).astype(np.float32)
    P = _stochastic(rng, n)
    (jW, tW), (jP, tP) = _both(W, dtype), _both(P, dtype)
    jax_ref = jax_mix_ref(jW, jP)
    jax_ops = jax_gossip_ops.gossip_mix(jW, jP, interpret=True)
    port_ref = gossip_mix_ref(tW, tP)
    port_ops = gossip_ops.gossip_mix(tW, tP)
    assert port_ops.dtype == tW.dtype and port_ops.shape == (n, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(port_ref), _f32(jax_ref), **tol)
    np.testing.assert_allclose(_f32(port_ops), _f32(jax_ops), **tol)
    np.testing.assert_allclose(_f32(port_ops), _f32(jax_ref), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("E,n,d", [(1, 3, 7), (3, 8, 512), (4, 16, 1000),
                                   (2, 5, 513)])
def test_gossip_mix_batched_matches_reference(E, n, d, dtype):
    rng = np.random.default_rng(1000 * E + 10 * n + d)
    W = rng.normal(size=(E, n, d)).astype(np.float32)
    P = np.stack([_stochastic(rng, n) for _ in range(E)])
    (jW, tW), (jP, tP) = _both(W, dtype), _both(P, dtype)
    jax_ref = jax_mix_batched_ref(jW, jP)
    jax_ops = jax_gossip_ops.gossip_mix_batched(jW, jP, interpret=True)
    port_ref = gossip_mix_batched_ref(tW, tP)
    port_ops = gossip_ops.gossip_mix_batched(tW, tP)
    assert port_ops.dtype == tW.dtype and port_ops.shape == (E, n, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(port_ref), _f32(jax_ref), **tol)
    np.testing.assert_allclose(_f32(port_ops), _f32(jax_ops), **tol)
    # each problem is the single mix of its own P
    for e in range(E):
        np.testing.assert_allclose(
            _f32(port_ops[e]), _f32(gossip_ops.gossip_mix(tW[e], tP[e])),
            **tol)


def test_gossip_mix_multidim_leaves_and_identity():
    rng = np.random.default_rng(11)
    W = rng.normal(size=(8, 3, 5)).astype(np.float32)
    P = _stochastic(rng, 8)
    out = gossip_ops.gossip_mix(torch.as_tensor(W), torch.as_tensor(P))
    assert out.shape == (8, 3, 5)
    np.testing.assert_allclose(
        out.numpy().reshape(8, -1),
        np.asarray(jax_mix_ref(jnp.asarray(W.reshape(8, -1)),
                               jnp.asarray(P))), **_tol("float32"))
    # identity mixing returns every row exactly
    same = gossip_ops.gossip_mix(torch.as_tensor(W), torch.eye(8))
    np.testing.assert_array_equal(same.numpy(), W)
    Wb = rng.normal(size=(3, 6, 2, 4)).astype(np.float32)
    Pb = np.stack([_stochastic(rng, 6) for _ in range(3)])
    outb = gossip_ops.gossip_mix_batched(torch.as_tensor(Wb),
                                         torch.as_tensor(Pb))
    assert outb.shape == (3, 6, 2, 4)
    np.testing.assert_allclose(
        outb.numpy().reshape(3, 6, -1),
        np.asarray(jax_mix_batched_ref(jnp.asarray(Wb.reshape(3, 6, -1)),
                                       jnp.asarray(Pb))), **_tol("float32"))
    eyes = torch.eye(6).expand(3, 6, 6)
    np.testing.assert_array_equal(
        gossip_ops.gossip_mix_batched(torch.as_tensor(Wb), eyes).numpy(), Wb)


def _lanes(rng, n, kind):
    """Active-set lanes: pads in the middle and at the end, worker 0 active
    (``corners``), or every lane padded (``all_pad``)."""
    A = min(n, 4) + 2
    w = np.full(A, -1, dtype=np.int32)
    if kind == "all_pad":
        return w
    m = min(n, 4)
    pick = rng.choice(np.arange(1, n), size=m - 1, replace=False)
    active = np.sort(np.concatenate([[0], pick])).astype(np.int32)
    slots = [0, 2, 3, 5][:m] if A > 4 else [0, 2, 4][:m]
    w[slots] = active
    return w


def _sparse_case(n, d, kind, seed):
    rng = np.random.default_rng(seed)
    w = _lanes(rng, n, kind)
    A = len(w)
    W = rng.normal(size=(n, d)).astype(np.float32)
    G = rng.normal(size=(A, d)).astype(np.float32)
    valid = (w >= 0).astype(np.float32)
    P = _stochastic(rng, A) * valid[:, None] * valid[None, :]
    mask = (rng.random(A) < 0.7).astype(np.float32) * np.float32(0.3) * valid
    return W, G, P.astype(np.float32), mask, w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d,kind", [(n, d, "corners") for n, d in SHAPES]
                         + [(8, 512, "all_pad")])
def test_sparse_gossip_matches_reference(n, d, kind, dtype):
    W, G, P, mask, w = _sparse_case(n, d, kind, seed=10 * n + d)
    (jW, tW), (jG, tG) = _both(W, dtype), _both(G, dtype)
    (jP, tP), (jm, tm) = _both(P, dtype), _both(mask, dtype)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    Q = (mask[:, None] * P).astype(np.float32)
    jQ, tQ = _both(Q, dtype)
    tol = _tol(dtype)
    # oracles (padded lanes already carry zero P/Q rows and columns)
    np.testing.assert_allclose(_f32(sparse_gossip_ref(tW, tG, tP, tQ, tw)),
                               _f32(jax_sparse_ref(jW, jG, jP, jQ, jw)), **tol)
    # the ops contract: compact rows, then the full gather-mix-scatter
    rows = sparse_ops.sparse_gossip_rows(tW, tG, tP, tm, tw)
    jrows = jax_sparse_ops.sparse_gossip_rows(jW, jG, jP, jm, jw,
                                              interpret=True)
    np.testing.assert_allclose(_f32(rows), _f32(jrows), **tol)
    assert not rows[torch.as_tensor(w < 0)].to(torch.float32).any()
    applied = sparse_ops.scatter_active_rows(tW.clone(), rows, tw)
    np.testing.assert_allclose(_f32(applied),
                               _f32(jax_apply_ref(jW, jG, jP, jm, jw)), **tol)
    np.testing.assert_allclose(_f32(sparse_gossip_apply_ref(tW, tG, tP, tm, tw)),
                               _f32(jax_apply_ref(jW, jG, jP, jm, jw)), **tol)
    untouched = np.setdiff1d(np.arange(n), w[w >= 0])
    np.testing.assert_array_equal(_f32(applied)[untouched], _f32(tW)[untouched])


def _merged_case(a, n, d, seed):
    """A merged row as merge_event_groups packs it: cliques of 3-8 distinct
    workers one after another from lane 0 while they fit, then -1 lanes,
    a block-diagonal stochastic P_sub (one block per clique)."""
    rng = np.random.default_rng(seed)
    w = np.full(a, -1, dtype=np.int32)
    clique = np.full(a, -1)
    o = c = 0
    while True:
        m = int(rng.integers(3, 9))
        if o + m > a:
            break
        clique[o:o + m] = c
        o, c = o + m, c + 1
    w[:o] = rng.permutation(n)[:o]
    block = (clique[:, None] == clique[None, :]) & (clique[:, None] >= 0)
    P = (rng.random((a, a)) + np.eye(a)) * block
    P = (P / np.maximum(P.sum(axis=1, keepdims=True), 1e-30)).astype(np.float32)
    W = rng.normal(size=(n, d)).astype(np.float32)
    G = rng.normal(size=(a, d)).astype(np.float32)
    mask = ((rng.random(a) < 0.7) * 0.2 * (w >= 0)).astype(np.float32)
    return W, G, P, mask, w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sparse_gossip_rows_on_a_merged_row(dtype):
    """The main path's merged rows (A = 64 lanes of a 100-row carry)
    through the port's op and the reference's Pallas op in interpret mode."""
    W, G, P, mask, w = _merged_case(64, 100, 96, seed=64)
    (jW, tW), (jG, tG) = _both(W, dtype), _both(G, dtype)
    (jP, tP), (jm, tm) = _both(P, dtype), _both(mask, dtype)
    rows = sparse_ops.sparse_gossip_rows(tW, tG, tP, tm, torch.as_tensor(w))
    jrows = jax_sparse_ops.sparse_gossip_rows(jW, jG, jP, jm, jnp.asarray(w),
                                              interpret=True)
    np.testing.assert_allclose(_f32(rows), _f32(jrows), **_tol(dtype))
    assert not rows[torch.as_tensor(w < 0)].to(torch.float32).any()


def _rows_masked_per_leaf(W, G, P_sub, scaled_mask, workers):
    """The leaf op as it was when each leaf masked P_sub itself: the
    operands the hoisted helper must reproduce bit for bit."""
    N, A = W.shape[0], workers.shape[0]
    valid = workers >= 0
    gidx = torch.where(valid, workers, 0).to(torch.int32).contiguous()
    vf = valid.to(P_sub.dtype)
    P = P_sub * vf[:, None] * vf[None, :]
    Q = (scaled_mask * vf).to(P.dtype)[:, None] * P
    flat_w = W.reshape(N, -1).contiguous()
    flat_g = G.reshape(A, -1).to(flat_w.dtype).contiguous()
    out = sparse_ops.sparse_gossip_compact(
        flat_w, flat_g, P.to(flat_w.dtype).contiguous(),
        Q.to(flat_w.dtype).contiguous(), gidx)
    return out.reshape((A,) + tuple(W.shape[1:]))


@pytest.mark.parametrize("kind", ["corners", "merged"])
def test_event_operands_built_once_give_the_same_rows(kind):
    """active_set_operands once per event, then mix_active_leaf per leaf,
    equals the per-leaf masking exactly, for every leaf shape of the 2-NN
    kind (matrix, vector, multi-dim) and in bfloat16 too."""
    if kind == "merged":
        _, _, P, mask, w = _merged_case(32, 40, 8, seed=5)
    else:
        _, _, P, mask, w = _sparse_case(8, 16, "corners", seed=5)
    rng = np.random.default_rng(6)
    A, n = len(w), int(w.max()) + 3
    tP, tm, tw = (torch.as_tensor(x) for x in (P, mask, w))
    for dt in (torch.float32, torch.bfloat16):
        ops = sparse_ops.active_set_operands(tP.to(dt), tm.to(dt), tw, dt)
        for shape in ((n, 33), (n,), (n, 3, 5)):
            W = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(dt)
            G = torch.as_tensor(rng.normal(size=(A,) + shape[1:])
                                .astype(np.float32))
            hoisted = sparse_ops.mix_active_leaf(W, G, *ops)
            old = _rows_masked_per_leaf(W, G, tP.to(dt), tm.to(dt), tw)
            assert hoisted.dtype == dt and hoisted.shape == (A,) + shape[1:]
            assert torch.equal(hoisted, old)
            assert torch.equal(sparse_ops.sparse_gossip_rows(
                W, G, tP.to(dt), tm.to(dt), tw), old)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["corners", "all_pad"])
@pytest.mark.parametrize("n,d", [(3, 7), (8, 512), (16, 1000)])
def test_scatter_rows_matches_reference(n, d, kind, dtype):
    rng = np.random.default_rng(n + d)
    w = _lanes(rng, n, kind)
    X = rng.normal(size=(n, d)).astype(np.float32)
    R = rng.normal(size=(len(w), d)).astype(np.float32)
    (jX, tX), (jR, tR) = _both(X, dtype), _both(R, dtype)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    ref = _f32(jax_scatter_ref(jX, jR, jw))
    jX_own = jnp.array(jX)  # the op donates its carry argument
    jout = jax_sparse_ops.sparse_scatter_rows(jX_own, jR, jw,  # repro: disable=kernel-gate
                                              interpret=True)
    np.testing.assert_array_equal(_f32(jout), ref)
    np.testing.assert_array_equal(_f32(sparse_scatter_rows_ref(tX, tR, tw)), ref)
    carry = tX.clone()
    out = sparse_ops.scatter_active_rows(carry, tR, tw)
    assert out is carry  # updated in place
    np.testing.assert_array_equal(_f32(carry), ref)


def test_cpu_tensors_never_launch_a_kernel():
    rng = np.random.default_rng(3)
    before = (gossip_ops.masked_gossip_cuda.launches,
              sparse_ops.sparse_gossip_cuda.launches,
              sparse_ops.scatter_rows_cuda.launches)
    W, G, P, mask, w = _sparse_case(8, 64, "corners", seed=3)
    tW, tG, tP, tm, tw = (torch.as_tensor(x) for x in (W, G, P, mask, w))
    sparse_ops.sparse_gossip_rows(tW, tG, tP, tm, tw)
    sparse_ops.scatter_active_rows(tW.clone(), tG, tw)
    gossip_ops.masked_gossip_mix(tW, torch.as_tensor(
        rng.normal(size=(8, 64)).astype(np.float32)),
        torch.eye(8), torch.zeros(8))
    gossip_ops.gossip_mix(tW, torch.eye(8))
    gossip_ops.gossip_mix_batched(tW[None], torch.eye(8)[None])
    assert before == (0, 0, 0)
    assert (gossip_ops.masked_gossip_cuda.launches,
            sparse_ops.sparse_gossip_cuda.launches,
            sparse_ops.scatter_rows_cuda.launches,
            gossip_ops.gossip_mix_cuda.launches,
            gossip_ops.gossip_mix_batched_cuda.launches) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("call", ["masked", "sparse", "scatter", "mix",
                                  "batched"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper raises on what it cannot launch on; it never
    substitutes the plain version."""
    W = torch.zeros(4, 8)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "masked":
            gossip_ops.masked_gossip_cuda(W, W, torch.eye(4), torch.eye(4))
        elif call == "sparse":
            sparse_ops.sparse_gossip_cuda(W, W, torch.eye(4), torch.eye(4), idx)
        elif call == "mix":
            gossip_ops.gossip_mix_cuda(W, torch.eye(4))
        elif call == "batched":
            gossip_ops.gossip_mix_batched_cuda(W[None], torch.eye(4)[None])
        else:
            sparse_ops.scatter_rows_cuda(W, W, idx)
    assert sparse_ops.scatter_rows_cuda.launches == 0


def _dense_cuda_call(call, n, body):
    """One dense wrapper on CPU operands of n rows with ``body``."""
    W, P = torch.zeros(n, 8), torch.eye(n)
    if call == "masked":
        return gossip_ops.masked_gossip_cuda(W, W, P, P, body=body)
    if call == "mix":
        return gossip_ops.gossip_mix_cuda(W, P, body=body)
    return gossip_ops.gossip_mix_batched_cuda(W[None], P[None], body=body)


@pytest.mark.parametrize("call", ["masked", "mix", "batched"])
@pytest.mark.parametrize("body,n,match", [
    ("wgmma", 4, "body must be one of"),
    ("cores", gossip_ops.CORES_MAX_N + 1, "CUDA-core body takes N <= "),
])
def test_dense_wrappers_refuse_a_body_before_building(monkeypatch, call, body,
                                                      n, match):
    """An unknown body, and the CUDA-core body above the N it takes, raise
    ValueError before the library is loaded (or a device is checked)."""
    def no_load(*args, **kw):
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(build, "load", no_load)
    with pytest.raises(ValueError, match=match):
        _dense_cuda_call(call, n, body)
    assert (gossip_ops.masked_gossip_cuda.launches,
            gossip_ops.gossip_mix_cuda.launches,
            gossip_ops.gossip_mix_batched_cuda.launches) == (0, 0, 0)


@pytest.mark.parametrize("body", [None, "cores", "tensor"])
def test_dense_wrappers_take_every_body_up_to_the_device_check(body):
    """A body that takes N goes on to the operand checks: CPU tensors are
    refused there, never run by a plain version."""
    for call in ("masked", "mix", "batched"):
        with pytest.raises(ValueError, match="on one CUDA device"):
            _dense_cuda_call(call, gossip_ops.CORES_MAX_N, body)


def test_cores_max_n_is_the_sources_max_rb():
    """The wrappers' CORES_MAX_N (the widest N a forced "cores" takes) is
    the C dispatch's MAX_RB, read from csrc/small_mix.cuh, and the rule's
    SMALL_N lies within it."""
    text = (build.CSRC / "small_mix.cuh").read_text()
    assert re.findall(r"constexpr int MAX_RB = (\d+);", text) == [
        str(gossip_ops.CORES_MAX_N)]
    small = re.findall(r"constexpr int SMALL_N = (\d+);", text)
    assert len(small) == 1 and 1 <= int(small[0]) <= gossip_ops.CORES_MAX_N


def test_build_names_a_content_hashed_library_per_source():
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").is_file()
    with pytest.raises(ValueError, match="unknown kernel"):
        build.build(["not_a_kernel"])


# ---------------------------------------------------------------------------
# linear_scan and swa_attention (the hybrid LM's sequence operators)
# ---------------------------------------------------------------------------

_jit_rglru_scan = jax.jit(jax_rglru_scan)
_jit_swa_ref = jax.jit(jax_swa_ref, static_argnames=("window", "n_groups"))


def _decays(rng, shape, kind):
    """RG-LRU-like decays in [σ(2)^8, 1) (``gate``), or the edges 0 and 1."""
    if kind == "zero":
        return np.zeros(shape, np.float32)
    if kind == "one":
        return np.ones(shape, np.float32)
    return (0.36 + 0.64 * rng.random(shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,W,kind", [
    (1, 1, 7, "gate"), (2, 37, 64, "gate"), (3, 100, 33, "gate"),
    (2, 64, 16, "zero"), (1, 80, 16, "one")])
def test_linear_scan_plain_matches_reference(B, T, W, kind, dtype):
    rng = np.random.default_rng(B * 1000 + T * 10 + W)
    a = _decays(rng, (B, T, W), kind)
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    (ja, ta), (jx, tx) = _both(a, dtype), _both(x, dtype)
    out = scan_ops.linear_scan(ta, tx)
    assert out.dtype == tx.dtype and out.shape == (B, T, W)
    np.testing.assert_allclose(_f32(out), _f32(jax_scan_ref(ja, jx)),
                               **_tol(dtype))
    if kind == "zero":
        np.testing.assert_array_equal(_f32(out), _f32(tx))


@pytest.mark.parametrize("T", [200, 512])
def test_linear_scan_plain_matches_rglru_scan(T):
    """The reference's chunked associative scan (one tree for T <= 256,
    chunks of 256 with a carried boundary for T = 512) against the port's
    sequential plain version: another rounding order, float32 tolerance."""
    rng = np.random.default_rng(T)
    a = _decays(rng, (2, T, 48), "gate")
    x = rng.normal(size=(2, T, 48)).astype(np.float32)
    out = scan_ops.linear_scan(torch.as_tensor(a), torch.as_tensor(x))
    ref = _jit_rglru_scan(jnp.asarray(a), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("float32"))


SWA_CASES = [  # B, T, H, KV, dh, window
    (1, 64, 2, 2, 16, 64),      # window = T
    (2, 100, 4, 2, 16, 24),     # GQA 2, T not a tile multiple
    (1, 96, 4, 1, 32, 1),       # MQA, window 1: each query sees itself
    (1, 50, 2, 1, 8, 500),      # window well past T: causal attention
    (2, 130, 8, 2, 16, 64),     # GQA 4, window < T
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,H,KV,dh,w", SWA_CASES)
def test_swa_attention_plain_matches_reference(B, T, H, KV, dh, w, dtype):
    rng = np.random.default_rng(T + w + dh)
    q, k, v = (rng.normal(size=(B, T, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    (jq, tq), (jk, tk), (jv, tv) = (_both(t, dtype) for t in (q, k, v))
    out = swa_ops.swa_attention(tq, tk, tv, window=w)
    assert out.shape == (B, T, H, dh) and out.dtype == tq.dtype
    flat = [j.transpose(0, 2, 1, 3).reshape(B * j.shape[2], T, dh)
            for j in (jq, jk, jv)]
    ref = _jit_swa_ref(*flat, window=w, n_groups=H // KV)
    ref = ref.reshape(B, H, T, dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))
    if w == 1:
        np.testing.assert_allclose(
            _f32(out), _f32(torch.repeat_interleave(tv, H // KV, dim=2)),
            **_tol(dtype))


# The CUDA kernel's tile edges (128 query rows a block; 128-key tiles at
# dh 64 and 128, 64 at dh 256) and windows about a tile, GQA 6 and 7 at a
# ragged T: the oracle the card holds the kernel to, pinned here against
# the reference at the same T, windows and groups (narrow heads).
SWA_EDGE_CASES = (
    [(1, T, 2, 1, 8, w) for T in (127, 128, 129, 255, 257)
     for w in (1, 127, 128, 129)]
    + [(1, 257, 6, 1, 8, 257), (1, 129, 7, 1, 8, 129),
       (2, 255, 12, 2, 8, 128), (1, 200, 14, 2, 8, 127)])


@pytest.mark.parametrize("B,T,H,KV,dh,w", SWA_EDGE_CASES)
def test_swa_attention_plain_at_the_kernel_tile_edges(B, T, H, KV, dh, w):
    rng = np.random.default_rng(T * 7 + w + H)
    q, k, v = (rng.normal(size=(B, T, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    out = swa_ops.swa_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                                window=w)
    flat = [jnp.asarray(t.transpose(0, 2, 1, 3).reshape(B * t.shape[2], T, dh))
            for t in (q, k, v)]
    ref = _jit_swa_ref(*flat, window=w, n_groups=H // KV)
    ref = np.asarray(ref).reshape(B, H, T, dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref, **_tol("float32"))


def _fused_views(x, H, KV, dh):
    """q, k and v cut from one fused (B, T, (H + 2·KV)·dh) projection: the
    (B, T, H, dh) views a model hands over, strided, not contiguous."""
    return tuple(t.unflatten(-1, (-1, dh))
                 for t in x.split((H * dh, KV * dh, KV * dh), dim=-1))


def test_swa_attention_takes_strided_views():
    """Views of one fused projection give the reference's result (the
    CPU path flattens them; the card reads them through tensor maps)."""
    B, T, H, KV, dh, w = 2, 130, 6, 2, 16, 64
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, T, (H + 2 * KV) * dh)).astype(np.float32)
    q, k, v = _fused_views(torch.as_tensor(x), H, KV, dh)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    out = swa_ops.swa_attention(q, k, v, window=w)
    assert out.shape == (B, T, H, dh)
    flat = [jnp.asarray(t.numpy().transpose(0, 2, 1, 3).reshape(
        B * t.shape[2], T, dh)) for t in (q, k, v)]
    ref = _jit_swa_ref(*flat, window=w, n_groups=H // KV)
    ref = np.asarray(ref).reshape(B, H, T, dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref, **_tol("float32"))


def test_tma_strides_of_views_a_tensor_map_takes():
    B, T, H, KV, dh = 2, 33, 6, 2, 64
    x = torch.zeros(B, T, (H + 2 * KV) * dh, dtype=torch.bfloat16)
    q, k, _ = _fused_views(x, H, KV, dh)
    row = (H + 2 * KV) * dh
    assert swa_ops.tma_strides(q, "q") == [T * row, row, dh]
    assert swa_ops.tma_strides(k, "k") == [T * row, row, dh]
    # a size-1 dim is never stepped: its stride is replaced by dh
    one = torch.zeros(1, 1, 1, 128, dtype=torch.bfloat16)
    assert swa_ops.tma_strides(one, "q") == [128, 128, 128]
    # the (B·H, T, dh) entry's view: heads as one batch row
    flat = torch.zeros(12, T, dh, dtype=torch.bfloat16)
    assert swa_ops.tma_strides(flat.unsqueeze(0).transpose(1, 2), "q") == [
        dh, dh, T * dh]


@pytest.mark.parametrize("what", ["head dim", "row stride", "base"])
def test_tma_strides_refuses_what_a_tensor_map_cannot_take(what):
    B, T, H, dh = 1, 8, 2, 64
    if what == "head dim":       # dh not contiguous
        t = torch.zeros(B, T, dh, H, dtype=torch.bfloat16).transpose(2, 3)
    elif what == "row stride":   # rows 130 bf16 = 260 bytes apart
        t = torch.zeros(B, T, H * dh + 2, dtype=torch.bfloat16)[
            ..., :H * dh].unflatten(-1, (H, dh))
    else:                        # base 2 bytes off a 16-byte boundary
        t = torch.zeros(B * T * H * dh + 1, dtype=torch.bfloat16)[1:].view(
            B, T, H, dh)
    with pytest.raises(ValueError, match="swa_attention: q .*TMA"):
        swa_ops.tma_strides(t, "q")


def test_swa_attention_plain_matches_pallas_interpret():
    """The port's public (B, T, H, dh) op against the reference's Pallas op
    run in interpret mode, with ragged T and GQA."""
    B, T, H, KV, dh, w = 1, 70, 4, 2, 16, 20
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(B, T, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    out = swa_ops.swa_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                                window=w)
    ref = jax_swa_ops.swa_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                    window=w, block_q=32, block_k=32,
                                    interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("float32"))


@pytest.mark.parametrize("call", ["linear_scan", "swa_attention"])
def test_sequence_kernel_wrappers_refuse_cpu_tensors(call):
    x = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "linear_scan":
            scan_ops.linear_scan_cuda(x, x)
        else:
            swa_ops.swa_attention_cuda(x, x, x, window=4)
    assert scan_ops.linear_scan_cuda.launches == 0
    assert swa_ops.swa_attention_cuda.launches == 0
