"""The port's gossip kernels against the JAX package's, on the CPU.

Inputs are drawn once with NumPy and fed to both packages.  On CPU tensors
the port's wrappers run their plain PyTorch versions (the CUDA kernels run
only on the card, where ``chip_smoke.py`` holds them against the same plain
versions); those are held here against the reference's ``ref.py`` oracles
and against its Pallas ops run in interpret mode.  Tolerances are
``tests/test_kernels.py:_tol``'s: float32 atol 2e-5 / rtol 1e-4 (sums in a
different order), bfloat16 2e-2 (one rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_mix import ops as jax_gossip_ops
from repro.kernels.gossip_mix.ref import masked_gossip_ref as jax_masked_ref
from repro.kernels.sparse_gossip import ops as jax_sparse_ops
from repro.kernels.sparse_gossip.ref import (
    sparse_gossip_apply_ref as jax_apply_ref,
    sparse_gossip_ref as jax_sparse_ref,
    sparse_scatter_rows_ref as jax_scatter_ref)
from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import ops as gossip_ops
from repro_torch.kernels.gossip_mix.ref import masked_gossip_ref
from repro_torch.kernels.sparse_gossip import ops as sparse_ops
from repro_torch.kernels.sparse_gossip.ref import (sparse_gossip_apply_ref,
                                                  sparse_gossip_ref,
                                                  sparse_scatter_rows_ref)

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
    assert before == (0, 0, 0)
    assert (gossip_ops.masked_gossip_cuda.launches,
            sparse_ops.sparse_gossip_cuda.launches,
            sparse_ops.scatter_rows_cuda.launches) == (0, 0, 0)


@pytest.mark.parametrize("call", ["masked", "sparse", "scatter"])
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
        else:
            sparse_ops.scatter_rows_cuda(W, W, idx)
    assert sparse_ops.scatter_rows_cuda.launches == 0


def test_build_names_a_content_hashed_library_per_source():
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").is_file()
    with pytest.raises(ValueError, match="unknown kernel"):
        build.build(["not_a_kernel"])
