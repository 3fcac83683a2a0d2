"""The port's CUDA kernels and trainer on the card.

Every test here needs a CUDA device and nvcc; without one each test skips
(decided inside the ``cuda`` fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (float32 atol 2e-5 / rtol 1e-4, bfloat16 2e-2; the scatter is an
exact copy), and a short trainer run on the card against the same run on
the CPU from the same W0.
"""
import pytest
import torch

from repro_torch.kernels.gossip_mix import ops as gossip_ops
from repro_torch.kernels.sparse_gossip import ops as sparse_ops
from repro_torch.xp import ExperimentSpec, build_trainer, mlp2nn_init

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(a, b, dt):
    torch.testing.assert_close(a.float(), b.float(), **TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(3, 7), (16, 1000), (65, 513), (256, 2560)])
def test_masked_gossip_kernel_matches_plain(cuda, n, d, dt):
    g = torch.Generator().manual_seed(n + d)
    W = torch.randn(n, d, generator=g).to(cuda, dt)
    G = torch.randn(n, d, generator=g).to(cuda, dt)
    P = torch.rand(n, n, generator=g).to(cuda, dt)
    Q = (torch.rand(n, n, generator=g) * 0.1).to(cuda, dt)
    before = gossip_ops.masked_gossip_cuda.launches
    out = gossip_ops.masked_gossip_cuda(W, G, P, Q)
    assert gossip_ops.masked_gossip_cuda.launches == before + 1
    _close(out, gossip_ops.masked_gossip_plain(W, G, P, Q), dt)
    # the dispatching op launches the kernel for CUDA tensors
    out2 = gossip_ops.masked_gossip_update(W, G, P, Q)
    assert gossip_ops.masked_gossip_cuda.launches == before + 2
    assert torch.equal(out, out2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a", [2, 16, 40, 64, 300])
def test_sparse_kernels_match_plain(cuda, a, dt):
    n, d = 512, 777
    g = torch.Generator().manual_seed(a)
    w = torch.randperm(n, generator=g)[:a]
    w[0] = 0
    w[torch.randperm(a, generator=g)[:a // 3]] = -1   # pads in any lane
    w = w.to(torch.int32).to(cuda)
    W = torch.randn(n, d, generator=g).to(cuda, dt)
    G = torch.randn(a, d, generator=g).to(cuda, dt)
    P = torch.rand(a, a, generator=g).to(cuda)
    m = (torch.rand(a, generator=g) * 0.3).to(cuda)
    rows = sparse_ops.sparse_gossip_rows(W, G, P, m, w)   # kernel path
    valid = w >= 0
    vf = valid.to(P.dtype)
    Pm = (P * vf[:, None] * vf[None, :]).to(dt)
    Qm = ((m * vf)[:, None] * P * vf[:, None] * vf[None, :]).to(dt)
    gidx = torch.where(valid, w, 0).to(torch.int32)
    _close(rows, sparse_ops.sparse_gossip_plain(W, G, Pm, Qm, gidx), dt)
    assert not rows[~valid].float().any()
    X1, X2 = W.clone(), W.clone()
    sparse_ops.scatter_active_rows(X1, rows, w)
    sparse_ops.scatter_rows_plain(X2, rows, w)
    assert torch.equal(X1, X2)


def test_all_pad_row_writes_nothing(cuda):
    X = torch.randn(32, 100, device=cuda)
    before = X.clone()
    w = torch.full((8,), -1, dtype=torch.int32, device=cuda)
    sparse_ops.scatter_rows_cuda(X, torch.randn(8, 100, device=cuda), w)
    assert torch.equal(X, before)


def test_wrappers_refuse_what_they_cannot_launch(cuda):
    W = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        sparse_ops.scatter_rows_cuda(W, W, torch.zeros(4, dtype=torch.int64,
                                                        device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        gossip_ops.masked_gossip_cuda(W.double(), W.double(),
                                      torch.eye(4, device=cuda).double(),
                                      torch.eye(4, device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        gossip_ops.masked_gossip_cuda(W.t().contiguous().t(), W,
                                      torch.eye(4, device=cuda),
                                      torch.eye(4, device=cuda))


@pytest.mark.parametrize("alg,mode,n,dtype", [
    ("dsgd_aau", "sparse_scan", 32, "float32"),
    ("ad_psgd", "sparse_scan", 16, "float32"),
    ("dsgd_sync", "scan", 16, "float32"),
    ("dsgd_aau", "sparse_scan", 32, "bfloat16"),
])
def test_trainer_on_the_card_matches_the_cpu(cuda, alg, mode, n, dtype):
    """Same W0, same stream: float32 within 1e-4; bfloat16 within its
    rounding (the card and the CPU sum in another order, each step rounding
    the state to bf16)."""
    tol = 1e-4 if dtype == "float32" else 2e-2
    spec = ExperimentSpec(scales=(n,), mode=mode, max_time=None, max_events=64,
                          dtype=dtype)
    w0 = mlp2nn_init()(torch.Generator().manual_seed(0))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        tr = build_trainer(spec, alg, n, 0, device=dev,
                           init_params={k: v.to(dev) for k, v in w0.items()})
        runs[dev.type] = (tr, tr.run(max_events=64, eval_every=16))
    (tg, rg), (tc, rc) = runs["cuda"], runs["cpu"]
    for k in tg.W:
        assert tg.W[k].dtype == tc.W[k].dtype
        torch.testing.assert_close(tg.W[k].cpu().float(), tc.W[k].float(),
                                   atol=tol, rtol=10 * tol)
    torch.testing.assert_close(tg.y.cpu(), tc.y, atol=1e-5, rtol=1e-5)
    assert torch.equal(tg._ptr.cpu(), tc._ptr)
    for p, q in zip(rg.history, rc.history):
        assert (p.k, p.time, p.comm_param_copies) == (q.k, q.time,
                                                      q.comm_param_copies)
        assert abs(p.loss - q.loss) <= tol
