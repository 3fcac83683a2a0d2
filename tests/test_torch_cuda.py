"""The port's CUDA kernels and trainer on the card.

Every test here needs a CUDA device and nvcc; without one each test skips
(decided inside the ``cuda`` fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (float32 atol 2e-5 / rtol 1e-4, bfloat16 2e-2; the scatter is an
exact copy), a short trainer run on the card against the same run on the
CPU from the same W0, and the reduced RecurrentGemma, a reduced dense LM,
the reduced MoE LMs (grok-1, arctic) and the reduced rwkv6, musicgen and
llava-next on the card against the same weights on the CPU (logits within
1e-4, identical greedy tokens), the dense LM also trained on both.
"""
import pytest
import torch

import numpy as np

from repro_torch.configs import get_config
from repro_torch.kernels.gossip_mix import ops as gossip_ops
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import serve
from repro_torch.examples import decentralized_lm
from repro_torch.models import transformer as T
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
@pytest.mark.parametrize("n,d", [(3, 7), (16, 1000), (65, 513), (256, 2560),
                                 # N off a multiple of 32: each half of the
                                 # stacked reduction is padded on its own
                                 (3, 4097), (33, 4097), (65, 10), (100, 10),
                                 (100, 4096), (256, 10), (256, 65536)])
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


# the 100m LM preset's widest leaf, layers.ffn.w_* of shape (12, 768, 2304)
LM_LEAF_D = 12 * 768 * 2304


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_masked_gossip_at_the_lm_leaf(cuda, dt):
    """N = 8 workers of the 100m preset's widest leaf (D = 21,233,664: the
    64-bit offsets and a grid of D tiles past 65,536)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    W = torch.randn(8, LM_LEAF_D, generator=g, device=cuda).to(dt)
    G = torch.randn(8, LM_LEAF_D, generator=g, device=cuda).to(dt)
    P = torch.rand(8, 8, generator=g, device=cuda).to(dt)
    Q = (torch.rand(8, 8, generator=g, device=cuda) * 0.1).to(dt)
    _close(gossip_ops.masked_gossip_cuda(W, G, P, Q),
           gossip_ops.masked_gossip_plain(W, G, P, Q), dt)


def _offset(rows, cols, g, cuda, dt, offset=1):
    """A contiguous (rows, cols) view whose data starts ``offset`` elements
    into its buffer: not 16-byte aligned for offset 1."""
    base = torch.randn(rows * cols + offset, generator=g).to(cuda, dt)
    return base[offset:].view(rows, cols)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(33, 4096), (256, 2560)])
def test_masked_gossip_offset_views(cuda, n, d, dt):
    """W or G off a 16-byte boundary: the kernel copies 4 bytes (float32)
    or loads elements (bfloat16) instead of 16-byte vectors."""
    g = torch.Generator().manual_seed(3 * n + d)
    P = torch.rand(n, n, generator=g).to(cuda, dt)
    Q = (torch.rand(n, n, generator=g) * 0.1).to(cuda, dt)
    for w_off, g_off in ((1, 0), (0, 1)):
        W = _offset(n, d, g, cuda, dt, w_off)
        G = _offset(n, d, g, cuda, dt, g_off)
        assert (W.data_ptr() | G.data_ptr()) % 16
        out = gossip_ops.masked_gossip_cuda(W, G, P, Q)
        _close(out, gossip_ops.masked_gossip_plain(W, G, P, Q), dt)


@pytest.mark.parametrize("d", [4096, 4097])
def test_masked_gossip_stays_near_the_exact_product(cuda, d):
    """Unnormalised P (outputs of order 10) and a Q of scale 0.1: the
    float32 kernel stays within 2e-5 of the float64 product."""
    n = 256
    g = torch.Generator().manual_seed(d)
    W, G = (torch.randn(n, d, generator=g).to(cuda) for _ in range(2))
    P = torch.rand(n, n, generator=g).to(cuda)
    Q = (torch.rand(n, n, generator=g) * 0.1).to(cuda)
    exact = P.double().T @ W.double() - Q.double().T @ G.double()
    out = gossip_ops.masked_gossip_cuda(W, G, P, Q)
    assert float((out.double() - exact).abs().max()) <= 2e-5


def test_masked_gossip_scratch_is_kept_per_stream(cuda):
    """The split scratch is reused by later calls on one stream and is a
    buffer of its own on another: calls queued on two streams at once, each
    with its own P and Q, each match the plain version."""
    n, d = 100, 4097
    g = torch.Generator().manual_seed(11)
    W, G = (torch.randn(n, d, generator=g).to(cuda) for _ in range(2))
    Ps = [torch.rand(n, n, generator=g).to(cuda) for _ in range(2)]
    Qs = [(torch.rand(n, n, generator=g) * 0.1).to(cuda) for _ in range(2)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(4):
        outs[0].append(gossip_ops.masked_gossip_cuda(W, G, Ps[0], Qs[0]))
        with torch.cuda.stream(side):
            outs[1].append(gossip_ops.masked_gossip_cuda(W, G, Ps[1], Qs[1]))
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    keys = [k for k in gossip_ops._SCRATCH if k[2:] == (1, n, 2)]
    assert len({k[1] for k in keys}) >= 2
    for i in range(2):
        ref = gossip_ops.masked_gossip_plain(W, G, Ps[i], Qs[i])
        for out in outs[i]:
            _close(out, ref, torch.float32)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 1), (3, 7), (63, 4097), (100, 511),
                                 (256, 2560), (256, 10), (256, 16384),
                                 (1, 2560), (63, 10), (100, 65536)])
def test_gossip_mix_kernel_matches_plain(cuda, n, d, dt):
    g = torch.Generator().manual_seed(7 * n + d)
    W = torch.randn(n, d, generator=g).to(cuda, dt)
    P = torch.rand(n, n, generator=g).to(cuda, dt)
    before = gossip_ops.gossip_mix_cuda.launches
    out = gossip_ops.gossip_mix_cuda(W, P)
    assert gossip_ops.gossip_mix_cuda.launches == before + 1
    _close(out, gossip_ops.gossip_mix_plain(W, P), dt)
    # the leaf op launches the kernel for CUDA tensors, any (N, ...) shape
    out2 = gossip_ops.gossip_mix(W.reshape((n, 1, d)), P)
    assert gossip_ops.gossip_mix_cuda.launches == before + 2
    assert torch.equal(out, out2.reshape(n, d))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,n,d", [(1, 8, 511), (7, 63, 1000), (32, 64, 4097),
                                   (32, 64, 10), (4, 256, 2560), (3, 100, 10)])
def test_gossip_mix_batched_kernel_matches_plain(cuda, e, n, d, dt):
    g = torch.Generator().manual_seed(e + n + d)
    W = torch.randn(e, n, d, generator=g).to(cuda, dt)
    P = torch.rand(e, n, n, generator=g).to(cuda, dt)
    before = gossip_ops.gossip_mix_batched_cuda.launches
    out = gossip_ops.gossip_mix_batched(W, P)
    assert gossip_ops.gossip_mix_batched_cuda.launches == before + 1
    _close(out, gossip_ops.gossip_mix_batched_plain(W, P), dt)
    for k in range(e):   # each problem is its own single mix
        assert torch.equal(out[k], gossip_ops.gossip_mix_cuda(W[k].contiguous(),
                                                              P[k].contiguous()))


def _sparse_lanes(g, a, n, kind):
    """(a,) int32 workers of a carry of n rows: distinct, worker 0 active.
    ``pads``: about a third of the lanes -1, in any position; ``merged``:
    a row as merge_event_groups packs it, the valid lanes of cliques of
    3-8 workers one after another from lane 0 while they fit, then -1
    lanes.  Also the lanes' block mask: all ones, or 1 within a clique (a
    block-diagonal P_sub)."""
    w = torch.cat([torch.zeros(1, dtype=torch.int64),
                   torch.randperm(n - 1, generator=g)[:a - 1] + 1])
    block = torch.ones(a, a)
    if kind == "pads":
        w[torch.randperm(a, generator=g)[:a // 3]] = -1
    else:
        clique = torch.full((a,), -1)
        o = c = 0
        while True:
            m = int(torch.randint(3, 9, (1,), generator=g))
            if o + m > a:
                break
            clique[o:o + m] = c
            o, c = o + m, c + 1
        w[o:] = -1
        block = ((clique[:, None] == clique[None, :])
                 & (clique[:, None] >= 0)).float()
    return w.to(torch.int32), block


def _sparse_operands(g, a, d, dt, cuda, kind="pads", n=512, offset=0):
    w, block = _sparse_lanes(g, a, n, kind)
    W = _offset(n, d, g, cuda, dt, offset)
    G = torch.randn(a, d, generator=g).to(cuda, dt)
    P = (torch.rand(a, a, generator=g) * block).to(cuda)
    m = (torch.rand(a, generator=g) * 0.3).to(cuda)
    return W, G, P, m, w.to(cuda)


def _check_sparse(W, G, P, m, w, dt, body=None):
    """The kernel's rows (through the leaf op, or the kernel with ``body``
    forced) against the plain version, padded lanes' rows exactly zero,
    the scatter an exact copy."""
    if body is None:
        rows = sparse_ops.sparse_gossip_rows(W, G, P, m, w)   # kernel path
    else:
        Pm, Qm, gidx = sparse_ops.active_set_operands(P, m, w, dt)
        rows = sparse_ops.sparse_gossip_cuda(W, G, Pm, Qm, gidx, body=body)
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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [10, 777, 65536])
@pytest.mark.parametrize("a", [2, 16, 17, 32, 33, 64, 100, 256, 300])
def test_sparse_kernels_match_plain(cuda, a, d, dt):
    """Both bodies' widths (the CUDA-core body to A = 32, the wgmma body
    above), ragged A and D, -1 lanes anywhere."""
    g = torch.Generator().manual_seed(a + d)
    _check_sparse(*_sparse_operands(g, a, d, dt, cuda), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_sparse_kernels_at_the_lm_leaf(cuda, dt):
    """A = 8 lanes of N = 8 workers at the 100m preset's widest leaf."""
    g = torch.Generator().manual_seed(21)
    _check_sparse(*_sparse_operands(g, 8, LM_LEAF_D, dt, cuda, n=8), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [777, 65536])
@pytest.mark.parametrize("a", [32, 64, 256])
def test_sparse_kernels_match_plain_on_merged_lanes(cuda, a, d, dt):
    """The main path's merged rows: cliques' valid lanes packed from lane
    0, block-diagonal P_sub."""
    g = torch.Generator().manual_seed(3 * a + d)
    _check_sparse(*_sparse_operands(g, a, d, dt, cuda, kind="merged"), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a", [16, 64])
def test_sparse_gossip_offset_views(cuda, a, dt):
    """W off a 16-byte boundary: both bodies copy 4 bytes (float32) or
    load elements (bfloat16) instead of whole chunks."""
    g = torch.Generator().manual_seed(5 * a)
    W, G, P, m, w = _sparse_operands(g, a, 4096, dt, cuda, offset=1)
    assert W.data_ptr() % 16
    _check_sparse(W, G, P, m, w, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [10, 65536])
@pytest.mark.parametrize("a", [2, 16, 17, 32])
@pytest.mark.parametrize("body", ["cores", "tensor"])
def test_sparse_gossip_bodies_match_plain(cuda, body, a, d, dt):
    """At the crossover's widths each body, forced, holds the plain
    version, so the rule may pick either."""
    g = torch.Generator().manual_seed(7 * a + d)
    _check_sparse(*_sparse_operands(g, a, d, dt, cuda), dt, body=body)


def test_sparse_gossip_counts_one_launch_per_call(cuda):
    """The counter counts wrapper calls, one per call, whichever body (and
    however many device kernels) the rule runs."""
    g = torch.Generator().manual_seed(1)
    for a in (2, 64):
        W, G, P, m, w = _sparse_operands(g, a, 256, torch.float32, cuda)
        Pm, Qm, gidx = sparse_ops.active_set_operands(P, m, w, torch.float32)
        before = sparse_ops.sparse_gossip_cuda.launches
        sparse_ops.sparse_gossip_cuda(W, G, Pm, Qm, gidx)
        sparse_ops.sparse_gossip_rows(W, G, P, m, w)
        assert sparse_ops.sparse_gossip_cuda.launches == before + 2
    assert (sparse_ops.sparse_gossip_kernels(2),
            sparse_ops.sparse_gossip_kernels(64)) == (1, 2)
    with pytest.raises(RuntimeError, match="sparse_gossip"):
        sparse_ops.sparse_gossip_cuda(W, G, Pm, Qm, gidx, body="cores")


@pytest.mark.parametrize("body", [None, "tensor"])
def test_sparse_gossip_stays_near_the_exact_product(cuda, body):
    """A = 256 rows gathered from a carry of 512, unnormalised P (outputs
    of order 10) and a Q of scale 0.1: the float32 kernel stays within
    2e-5 of the float64 product."""
    n, a, d = 512, 256, 16384
    g = torch.Generator().manual_seed(4)
    W = torch.randn(n, d, generator=g).to(cuda)
    G = torch.randn(a, d, generator=g).to(cuda)
    P = torch.rand(a, a, generator=g).to(cuda)
    Q = (torch.rand(a, a, generator=g) * 0.1).to(cuda)
    gidx = torch.randperm(n, generator=g)[:a].to(cuda, torch.int32)
    exact = (P.double().T @ W.double().index_select(0, gidx.long())
             - Q.double().T @ G.double())
    out = sparse_ops.sparse_gossip_cuda(W, G, P, Q, gidx, body=body)
    assert float((out.double() - exact).abs().max()) <= 2e-5


@pytest.mark.parametrize("dt,d,a,offset", [
    (torch.float32, 1001, 16, 0),     # D % 4 != 0: 4-byte copies
    (torch.bfloat16, 1004, 16, 0),    # D % 8 != 0: 2-byte copies
    (torch.bfloat16, 10, 2, 0),
    (torch.float32, 4096, 16, 1),     # offset views of X and rows
    (torch.bfloat16, 4096, 64, 1),
    (torch.float32, 65536, 2, 0),     # the fused path's width
    (torch.float32, 65536, 64, 0),    # the main shape: 16-byte copies
    (torch.bfloat16, 2560, 256, 0)])
def test_scatter_rows_copies_exactly(cuda, dt, d, a, offset):
    """Valid lanes copy their rows bit for bit, -1 in any lane writes
    nothing, and all lanes -1 leave X as it was."""
    n = 256
    g = torch.Generator().manual_seed(d + a + offset)
    w = torch.randperm(n, generator=g)[:a]
    w[torch.randperm(a, generator=g)[:max(1, a // 3)]] = -1
    w = w.to(torch.int32).to(cuda)
    X = _offset(n, d, g, cuda, dt, offset)
    rows = _offset(a, d, g, cuda, dt, offset)
    assert bool(X.data_ptr() % 16) == bool(offset)
    ref = sparse_ops.scatter_rows_plain(X.clone(), rows, w)
    before = sparse_ops.scatter_rows_cuda.launches
    sparse_ops.scatter_rows_cuda(X, rows, w)
    assert sparse_ops.scatter_rows_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(X, ref)
    kept = X.clone()
    sparse_ops.scatter_rows_cuda(X, rows, torch.full_like(w, -1))
    torch.cuda.synchronize()
    assert torch.equal(X, kept)


def test_all_pad_row_writes_nothing(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randn(32, 100, generator=gen, device=cuda)
    before = X.clone()
    w = torch.full((8,), -1, dtype=torch.int32, device=cuda)
    sparse_ops.scatter_rows_cuda(
        X, torch.randn(8, 100, generator=gen, device=cuda), w)
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
    with pytest.raises(TypeError, match="dtype"):
        gossip_ops.gossip_mix_cuda(W.double(), torch.eye(4, device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        gossip_ops.gossip_mix_cuda(W, torch.eye(5, device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        gossip_ops.gossip_mix_batched_cuda(W[None], torch.eye(4, device=cuda))


@pytest.mark.parametrize("alg,mode,n,dtype", [
    ("dsgd_aau", "sparse_scan", 32, "float32"),
    ("ad_psgd", "sparse_scan", 16, "float32"),
    ("dsgd_sync", "scan", 16, "float32"),
    ("dsgd_aau", "sparse_scan", 32, "bfloat16"),
    ("ad_psgd", "fused", 16, "float32"),
    ("agp", "fused", 16, "float32"),
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
    assert (rg.total_time, rg.total_comm_copies) == (rc.total_time,
                                                     rc.total_comm_copies)


@pytest.mark.parametrize("alg", ["dsgd_aau", "ad_psgd"])
def test_per_event_on_the_card_matches_the_cpu_and_the_scan(cuda, alg):
    """per_event launches gossip_mix and no masked_gossip; it agrees with
    itself on the CPU and with the dense scan (masked_gossip) on the card."""
    n = 16
    w0 = mlp2nn_init()(torch.Generator().manual_seed(0))
    runs = {}
    for dev, mode in ((cuda, "per_event"), (torch.device("cpu"), "per_event"),
                      (cuda, "scan")):
        spec = ExperimentSpec(scales=(n,), mode=mode, max_time=None,
                              max_events=48)
        tr = build_trainer(spec, alg, n, 0, device=dev, batch_pool=64,
                           init_params={k: v.to(dev) for k, v in w0.items()})
        tr.warmup(max_events=48)
        counts = (gossip_ops.gossip_mix_cuda.launches,
                  gossip_ops.masked_gossip_cuda.launches)
        res = tr.run(max_events=48, eval_every=16)
        counts = (gossip_ops.gossip_mix_cuda.launches - counts[0],
                  gossip_ops.masked_gossip_cuda.launches - counts[1])
        runs[(dev.type, mode)] = (tr, res, counts)
    tg, rg, cg = runs[("cuda", "per_event")]
    assert cg[0] > 0 and cg[1] == 0
    assert runs[("cpu", "per_event")][2] == (0, 0)
    for key in (("cpu", "per_event"), ("cuda", "scan")):
        tc, rc, _ = runs[key]
        for k in tg.W:
            torch.testing.assert_close(tg.W[k].cpu(), tc.W[k].cpu(),
                                       atol=1e-4, rtol=1e-3)
        torch.testing.assert_close(tg.y.cpu(), tc.y.cpu(), atol=1e-5,
                                   rtol=1e-5)
        for p, q in zip(rg.history, rc.history):
            assert (p.k, p.time, p.comm_param_copies) == (q.k, q.time,
                                                          q.comm_param_copies)
            assert abs(p.loss - q.loss) <= 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tn,W,kind", [
    (1, 1, 100, "gate"), (2, 100, 2560, "gate"), (4, 4096, 2560, "gate"),
    (3, 777, 100, "zero"), (2, 1000, 33, "one")])
def test_linear_scan_kernel_matches_plain(cuda, B, Tn, W, kind, dt):
    g = torch.Generator().manual_seed(B + Tn + W)
    a = {"gate": 0.36 + 0.64 * torch.rand(B, Tn, W, generator=g),
         "zero": torch.zeros(B, Tn, W), "one": torch.ones(B, Tn, W)}[kind]
    x = torch.randn(B, Tn, W, generator=g)
    if kind == "one":   # a running sum: keep it O(1), where the tolerance holds
        x = x / Tn ** 0.5
    a, x = a.to(cuda, dt), x.to(cuda, dt)
    before = scan_ops.linear_scan_cuda.launches
    out = scan_ops.linear_scan(a, x)
    assert scan_ops.linear_scan_cuda.launches == before + 1
    torch.cuda.synchronize()
    _close(out, scan_ops.linear_scan_plain(a, x), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tn,H,KV,dh,w", [
    (1, 1, 1, 1, 64, 1), (1, 100, 10, 1, 256, 64), (2, 257, 4, 2, 128, 2048),
    (1, 300, 2, 2, 64, 1), (1, 1030, 10, 1, 256, 500), (2, 64, 4, 1, 64, 64),
    # the serve waves' padded lengths, windows 1, 2048 and past T
    (1, 2795, 10, 1, 128, 1), (1, 2795, 10, 1, 256, 2048),
    (1, 3561, 10, 1, 128, 3562), (1, 3561, 10, 1, 256, 1),
    # qwen3-8b's prefill: dh 128, GQA 32/8, no window (window = T)
    (2, 1100, 32, 8, 128, 1100), (1, 4096, 32, 8, 128, 4096),
    # grok-1's and arctic's prefills: GQA 48/8 and 56/8, dh 128, no window
    (1, 2795, 48, 8, 128, 2795), (1, 3561, 56, 8, 128, 3561),
    # float32 keeps the CUDA-core kernel: dh = 64 at the float32 bound
    (1, 300, 4, 2, 64, 100)])
def test_swa_attention_kernel_matches_plain(cuda, B, Tn, H, KV, dh, w, dt):
    g = torch.Generator().manual_seed(Tn + w)
    q = torch.randn(B, Tn, H, dh, generator=g).to(cuda, dt)
    k = torch.randn(B, Tn, KV, dh, generator=g).to(cuda, dt)
    v = torch.randn(B, Tn, KV, dh, generator=g).to(cuda, dt)
    before = swa_ops.swa_attention_cuda.launches
    out = swa_ops.swa_attention(q, k, v, window=w)
    assert swa_ops.swa_attention_cuda.launches == before + 1
    torch.cuda.synchronize()
    flat = [t.transpose(1, 2).reshape(B * t.shape[2], Tn, dh) for t in (q, k, v)]
    ref = swa_ops.swa_attention_plain(*flat, window=w, n_groups=H // KV)
    _close(out, ref.reshape(B, H, Tn, dh).transpose(1, 2), dt)


@pytest.mark.parametrize("B,Tn,H,KV,dh,dt", [
    # musicgen-large's prefills (MHA 32/32, dh 64) at both waves' lengths,
    # then behind its 256 frames
    (4, 2795, 32, 32, 64, torch.bfloat16), (4, 3561, 32, 32, 64, torch.bfloat16),
    (4, 3817, 32, 32, 64, torch.bfloat16),
    # llava-next's (GQA 32/8, dh 128), then behind its 2880 patches
    (4, 2795, 32, 8, 128, torch.bfloat16), (4, 3561, 32, 8, 128, torch.bfloat16),
    (4, 6441, 32, 8, 128, torch.bfloat16),
    # float32 at musicgen's head width (the CUDA-core kernel)
    (1, 3817, 32, 32, 64, torch.float32)])
def test_swa_attention_at_the_audio_and_vlm_prefills(cuda, B, Tn, H, KV, dh, dt):
    """No window; the plain version one sequence at a time (its float32
    scores at B = 4, T = 6441 would take 21 GB at once)."""
    g = torch.Generator().manual_seed(Tn + dh)
    q = torch.randn(B, Tn, H, dh, generator=g).to(cuda, dt)
    k = torch.randn(B, Tn, KV, dh, generator=g).to(cuda, dt)
    v = torch.randn(B, Tn, KV, dh, generator=g).to(cuda, dt)
    before = swa_ops.swa_attention_cuda.launches
    out = swa_ops.swa_attention(q, k, v, window=None)
    assert swa_ops.swa_attention_cuda.launches == before + 1
    torch.cuda.synchronize()
    for b in range(B):
        flat = [t[b].transpose(0, 1).contiguous() for t in (q, k, v)]
        ref = swa_ops.swa_attention_plain(*flat, window=Tn, n_groups=H // KV)
        _close(out[b], ref.transpose(0, 1), dt)


def test_sequence_kernels_refuse_what_they_cannot_launch(cuda):
    x = torch.zeros(1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        swa_ops.swa_attention_cuda(x, x, x, window=4)
    y = torch.zeros(1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="window"):
        swa_ops.swa_attention_cuda(y, y, y, window=0)
    with pytest.raises(TypeError, match="dtype"):
        scan_ops.linear_scan_cuda(y.double(), y.double())


def test_reduced_lm_on_the_card_matches_the_cpu(cuda):
    """Same weights on both: prefill past the window and 6 decode steps,
    logits within 1e-4; the server's greedy tokens identical; each prefill
    launches one kernel per sequence layer."""
    cfg = get_config("recurrentgemma-2b").reduced()
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = T.init_model(cfg, None, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                             size=(3, 150)))
    scans, swas = scan_ops.linear_scan_cuda.launches, swa_ops.swa_attention_cuda.launches
    lg, st = T.prefill(card, cfg, toks.to(cuda), 160)
    assert (scan_ops.linear_scan_cuda.launches - scans,
            swa_ops.swa_attention_cuda.launches - swas) == (2, 1)
    lc, sc = T.prefill(cpu, cfg, toks, 160)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    tok = lc.argmax(-1)
    for i in range(6):
        lg, st = T.decode_step(card, cfg, tok.to(cuda), st, 150 + i)
        lc, sc = T.decode_step(cpu, cfg, tok, sc, 150 + i)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
    prompts = [np.random.default_rng(i).integers(1, cfg.vocab_size, size=n)
               for i, n in enumerate((70, 130, 9, 100, 66))]
    outs = []
    for model in (card, cpu):
        reqs = [serve.Request(i, p, 8) for i, p in enumerate(prompts)]
        serve.BatchedServer(cfg, model, 4, 140).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_reduced_dense_lm_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen3 (qk-norm, GQA) from the same weights: prefill and 6
    decode steps within 1e-4, one swa_attention launch per layer, the
    server's greedy tokens identical; lm_loss and its gradient (the
    training forward, which launches no kernel) within 1e-4."""
    cfg = get_config("qwen3-8b").reduced()
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = T.init_model(cfg, None, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                             size=(3, 150)))
    swas = swa_ops.swa_attention_cuda.launches
    lg, st = T.prefill(card, cfg, toks.to(cuda), 160)
    assert swa_ops.swa_attention_cuda.launches - swas == cfg.n_layers
    lc, sc = T.prefill(cpu, cfg, toks, 160)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    tok = lc.argmax(-1)
    for i in range(6):
        lg, st = T.decode_step(card, cfg, tok.to(cuda), st, 150 + i)
        lc, sc = T.decode_step(cpu, cfg, tok, sc, 150 + i)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
    outs = []
    for model in (card, cpu):
        reqs = [serve.Request(i, np.random.default_rng(i).integers(
            1, cfg.vocab_size, size=n), 8) for i, n in enumerate((70, 130, 9))]
        serve.BatchedServer(cfg, model, 2, 140).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    swas = swa_ops.swa_attention_cuda.launches
    grads = []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        batch = {"tokens": toks[:2, :64].to(dev)}
        grads.append(torch.func.grad(lambda p: T.lm_loss(p, cfg, batch))(
            T.flat_params(model)))
    assert swa_ops.swa_attention_cuda.launches == swas
    for k in grads[1]:
        torch.testing.assert_close(grads[0][k].cpu(), grads[1][k],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,over", [
    ("grok-1-314b", {}), ("grok-1-314b", {"moe_groups": 2}),
    ("arctic-480b", {}), ("arctic-480b", {"moe_capacity_factor": 0.25})])
def test_reduced_moe_lm_on_the_card_matches_the_cpu(cuda, arch, over):
    """Reduced grok-1 / arctic from the same weights, as reduced, with two
    dispatch groups and with a capacity that drops most pairs: prefill and 6
    decode steps within 1e-4, one swa_attention launch per layer, the
    server's greedy tokens identical; lm_loss and its gradient within
    1e-4."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = T.init_model(cfg, None, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                             size=(3, 150)))
    swas = swa_ops.swa_attention_cuda.launches
    lg, st = T.prefill(card, cfg, toks.to(cuda), 160)
    assert swa_ops.swa_attention_cuda.launches - swas == cfg.n_layers
    lc, sc = T.prefill(cpu, cfg, toks, 160)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    tok = lc.argmax(-1)
    for i in range(6):
        lg, st = T.decode_step(card, cfg, tok.to(cuda), st, 150 + i)
        lc, sc = T.decode_step(cpu, cfg, tok, sc, 150 + i)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
    outs = []
    for model in (card, cpu):
        reqs = [serve.Request(i, np.random.default_rng(i).integers(
            1, cfg.vocab_size, size=n), 8) for i, n in enumerate((70, 130, 9))]
        serve.BatchedServer(cfg, model, 2, 140).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    grads = []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        batch = {"tokens": toks[:2, :64].to(dev)}
        grads.append(torch.func.grad(lambda p: T.lm_loss(p, cfg, batch))(
            T.flat_params(model)))
    for k in grads[1]:
        torch.testing.assert_close(grads[0][k].cpu(), grads[1][k],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "musicgen-large",
                                  "llava-next-mistral-7b"])
def test_reduced_ssm_and_multimodal_lms_on_the_card_match_the_cpu(cuda, arch):
    """Reduced rwkv6 / musicgen / llava from the same weights: prefill of
    150 tokens (behind an 8-embedding prefix for musicgen and llava) and 6
    decode steps within 1e-4, one swa_attention launch per layer (none for
    rwkv6), the server's greedy tokens identical; lm_loss with the prefix
    within 1e-4, and rwkv6's gradient at T = 100 (64 + 36) within 1e-4."""
    cfg = get_config(arch).reduced()
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = T.init_model(cfg, None, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(3, 150)))
    P = cfg.n_prefix_tokens
    pre = torch.as_tensor(rng.normal(size=(3, P, cfg.d_model)) * 0.02).float() if P else None
    swas = swa_ops.swa_attention_cuda.launches
    lg, st = T.prefill(card, cfg, toks.to(cuda), P + 160,
                       prefix_embeds=None if pre is None else pre.to(cuda))
    assert swa_ops.swa_attention_cuda.launches - swas == (
        0 if cfg.family == "ssm" else cfg.n_layers)
    lc, sc = T.prefill(cpu, cfg, toks, P + 160, prefix_embeds=pre)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    tok = lc.argmax(-1)
    for i in range(6):
        lg, st = T.decode_step(card, cfg, tok.to(cuda), st, P + 150 + i)
        lc, sc = T.decode_step(cpu, cfg, tok, sc, P + 150 + i)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
    outs = []
    for model in (card, cpu):
        reqs = [serve.Request(i, np.random.default_rng(i).integers(
            1, cfg.vocab_size, size=n), 8) for i, n in enumerate((70, 130, 9))]
        serve.BatchedServer(cfg, model, 2, 140).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    losses, grads = [], []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        batch = {"tokens": toks[:2, :100].to(dev),
                 "prefix": None if pre is None else pre[:2].to(dev)}
        losses.append(T.lm_loss(model, cfg, batch))
        if cfg.family == "ssm":
            grads.append(torch.func.grad(lambda p: T.lm_loss(p, cfg, batch))(
                T.flat_params(model)))
    torch.testing.assert_close(losses[0].cpu(), losses[1], atol=1e-4, rtol=1e-4)
    for k in (grads[1] if grads else ()):
        torch.testing.assert_close(grads[0][k].cpu(), grads[1][k],
                                   atol=1e-4, rtol=1e-4)


def test_bf16_expert_products_return_float32_sums(cuda):
    """``bmm_f32`` on bf16 card tensors takes cuBLAS's float32 output (the
    reference's ``preferred_element_type``), as the float32 product of the
    same bf16 values gives it."""
    from repro_torch.models.layers import bmm_f32
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 37, 512, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(8, 512, 96, generator=g).to(cuda, torch.bfloat16)
    out = bmm_f32(a, b)
    assert out.dtype == torch.float32
    _close(out, torch.bmm(a.float(), b.float()), torch.float32)


@pytest.mark.parametrize("mode", ["scan", "sparse_scan"])
def test_lm_trainer_on_the_card_matches_the_cpu(cuda, mode):
    """The LM example's tiny preset at N = 8, 8 events, from one W0 (both
    trainers draw it on the host from seed 0): worker state within 1e-4,
    counters and copies exactly; the card's run launches its mode's gossip
    kernels."""
    cfg = decentralized_lm.preset_config("tiny")
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        tr = decentralized_lm.build_trainer(cfg, 8, 32, 4, device=dev,
                                            mode=mode, events_per_step=1)
        before = (gossip_ops.masked_gossip_cuda.launches,
                  sparse_ops.sparse_gossip_cuda.launches)
        runs[dev.type] = (tr, tr.run(max_events=8, eval_every=4))
        after = (gossip_ops.masked_gossip_cuda.launches,
                 sparse_ops.sparse_gossip_cuda.launches)
        if dev.type == "cuda":
            launched = [b - a for a, b in zip(before, after)]
            assert launched[mode == "sparse_scan"] > 0
    (tg, rg), (tc, rc) = runs["cuda"], runs["cpu"]
    for k in tg.W:
        torch.testing.assert_close(tg.W[k].cpu(), tc.W[k], atol=1e-4, rtol=1e-3)
    assert torch.equal(tg._ptr.cpu(), tc._ptr)
    for p, q in zip(rg.history, rc.history):
        assert (p.k, p.time, p.comm_param_copies) == (q.k, q.time,
                                                      q.comm_param_copies)
        assert abs(p.loss - q.loss) <= 1e-4


# -- observability on the card ------------------------------------------------

_SUMMARY_FLOATS = ("busy_t", "idle_t", "utilization", "utilization_mean",
                   "mix_age", "stale_mean")


def _same_summary(a, b):
    """Telemetry summaries: integers exactly, floats within 1e-4."""
    assert a.keys() == b.keys()
    for key in a:
        if key in _SUMMARY_FLOATS:
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-4)
        elif key == "bucket_occupancy":
            assert [(r["A"], r["events"]) for r in b[key]] == \
                [(r["A"], r["events"]) for r in a[key]]
        else:
            assert b[key] == a[key], key


@pytest.mark.parametrize("alg,mode,n", [("dsgd_aau", "sparse_scan", 32),
                                        ("dsgd_sync", "scan", 16),
                                        ("dsgd_aau", "per_event", 16),
                                        ("ad_psgd", "fused", 16)])
def test_telemetry_and_trace_on_the_card_match_the_cpu(cuda, alg, mode, n):
    """The device-resident counters and the traced identity stream agree
    between the card and the CPU: integer counters and trace arrays
    exactly, float counters within 1e-4, the wait-blame summary within
    1e-6."""
    spec = ExperimentSpec(scales=(n,), mode=mode, max_time=None,
                          max_events=64, telemetry=True, trace=True)
    w0 = mlp2nn_init()(torch.Generator().manual_seed(0))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        tr = build_trainer(spec, alg, n, 0, device=dev, batch_pool=64,
                           init_params={k: v.to(dev) for k, v in w0.items()})
        runs[dev.type] = (tr, tr.run(max_events=64, eval_every=16))
    (tg, rg), (tc, rc) = runs["cuda"], runs["cpu"]
    _same_summary(rc.telemetry, rg.telemetry)
    assert rg.telemetry["comm_copies"] == rg.total_comm_copies
    for key in ("times", "copies", "lane_ev", "lane_worker", "lane_fin",
                "lane_grad", "lane_restart", "edge_ev", "edge_src",
                "edge_dst"):
        np.testing.assert_array_equal(getattr(tg.last_trace, key),
                                      getattr(tc.last_trace, key))
    for key in ("straggler_tax", "busy_t", "wait_t", "blame_total",
                "residual_wait"):
        assert abs(rg.trace[key] - rc.trace[key]) <= 1e-6


@pytest.mark.parametrize("alg,mode", [("dsgd_aau", "sparse_scan"),
                                      ("ad_psgd", "fused")])
def test_sanitized_run_on_the_card(cuda, alg, mode, monkeypatch):
    """Under the sanitizer (CUDA's sync debug mode set to error) a run with
    telemetry and trace makes only its explicit fetches; a synchronising
    call slipped into the loop raises."""
    spec = ExperimentSpec(scales=(32,), mode=mode, max_time=None,
                          max_events=64, telemetry=True, trace=True)
    tr = build_trainer(spec, alg, 32, 0, device=cuda, batch_pool=64)
    tr.sanitize = True
    tr.warmup(max_events=64)
    res = tr.run(max_events=64, eval_every=16)
    # eval history + telemetry drain, and the fused trace drain
    assert tr.sanitizer_stats.fetches == (3 if mode == "fused" else 2)
    assert res.telemetry["comm_copies"] == res.total_comm_copies
    assert torch.cuda.get_sync_debug_mode() == 0
    block = ("_dispatch_sparse_block" if mode == "sparse_scan"
             else "_record_eval")
    orig = getattr(type(tr), block)

    def leaky(self, *args, **kw):
        self.y.cpu()                       # a blocking device→host copy
        return orig(self, *args, **kw)

    monkeypatch.setattr(type(tr), block, leaky)
    with pytest.raises(RuntimeError):
        tr.run(max_events=64, eval_every=16)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_cli_on_the_card_names_the_card(cuda, tmp_path):
    from repro_torch.xp.__main__ import main
    out = tmp_path / "smoke.json"
    assert main(["--preset", "fused_smoke", "--telemetry", "--trace",
                 "--out", str(out)]) == 0
    import json
    meta = json.loads(out.read_text())["meta"]
    assert meta["device"] == torch.cuda.get_device_name(0)
    assert meta["power_limit"].endswith("W")
    assert meta["torch"] == torch.__version__


# -- the production training launcher ----------------------------------------

def test_wrappers_refuse_autograd_on_the_card(cuda):
    """On CUDA tensors too: an operand that requires grad raises before any
    launch (the launch counter stays), and under no_grad the kernel runs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    W = torch.randn(4, 1000, generator=gen, device=cuda, requires_grad=True)
    P = torch.rand(4, 4, generator=gen, device=cuda)
    before = gossip_ops.gossip_mix_cuda.launches
    with pytest.raises(RuntimeError, match="gossip_mix: .*no backward"):
        gossip_ops.gossip_mix_cuda(W, P)
    a = torch.rand(1, 64, 128, generator=gen, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="linear_scan: .*no backward"):
        scan_ops.linear_scan_cuda(a, a.detach())
    q = torch.randn(2, 64, 64, generator=gen, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="swa_attention: .*no backward"):
        swa_ops.swa_attention_cuda(q, q.detach(), q.detach(), window=8)
    assert gossip_ops.gossip_mix_cuda.launches == before
    with torch.no_grad():
        _close(gossip_ops.gossip_mix_cuda(W, P),
               gossip_ops.gossip_mix_plain(W, P), torch.float32)


def test_gossip_mix_at_the_training_shape(cuda):
    """N = 4 workers in bf16, as the launcher's ring mixes every leaf
    (here 8 M columns; chip_smoke.py times the 655 M-column embed leaf)."""
    from repro_torch.launch.steps import default_gossip_weights, ring_matrix
    g = torch.Generator(device=cuda).manual_seed(4)
    W = torch.randn(4, 1 << 23, generator=g, device=cuda, dtype=torch.bfloat16)
    P = ring_matrix(4, default_gossip_weights(4, False)).to(cuda, torch.bfloat16)
    _close(gossip_ops.gossip_mix_cuda(W, P), gossip_ops.gossip_mix_plain(W, P),
           torch.bfloat16)


@pytest.mark.parametrize("arch,T_len", [("recurrentgemma-2b", 64),
                                        ("recurrentgemma-2b", 1280),
                                        ("rwkv6-1.6b", 64),
                                        ("llava-next-mistral-7b", 64)])
def test_train_step_card_vs_cpu(cuda, arch, T_len):
    """One ``build_train_step`` step at N = 2 from one float32 W0: W within
    1e-4 and the loss within 1e-5, one ``gossip_mix`` launch a leaf."""
    from repro_torch.launch import steps as ST
    cfg = get_config(arch).reduced()
    W0 = ST.stacked_init(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 2, T_len)).astype(np.int32))
    gw = ST.default_gossip_weights(2, False)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        batch = {"tokens": toks.to(dev)}
        if cfg.frontend:
            batch["prefix"] = torch.zeros(
                (2, 2, cfg.n_prefix_tokens, cfg.d_model), device=dev)
        W = {k: v.to(dev, copy=True) for k, v in W0.items()}
        before = gossip_ops.gossip_mix_cuda.launches
        res[dev.type] = ST.build_train_step(cfg, 2, logit_chunk=16,
                                            device=dev)(W, batch, 0.05, gw)
        launched = gossip_ops.gossip_mix_cuda.launches - before
        assert launched == (len(W) if dev.type == "cuda" else 0)
    (Wg, lg), (Wc, lc) = res["cuda"], res["cpu"]
    assert abs(float(lg) - float(lc)) <= 1e-5
    for k in Wc:
        torch.testing.assert_close(Wg[k].cpu(), Wc[k], atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape_a,shape_b", [((64, 96), (96, 40)),
                                             ((3, 64, 96), (3, 96, 40))])
def test_bf16_float32_products_are_differentiable(cuda, shape_a, shape_b):
    """``matmul_f32`` / ``bmm_f32`` of bf16 operands on the card (cuBLAS's
    float32 output) against the float32 product of the same values: the
    value within 1e-5 relative, the gradients within the bf16 bound."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(shape_a, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(shape_b, generator=g, device=cuda).to(torch.bfloat16)
    a.requires_grad_()
    b.requires_grad_()
    fn = L.matmul_f32 if a.dim() == 2 else L.bmm_f32
    y = fn(a, b)
    ref = a.float() @ b.float()
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-5)
    w = torch.randn(y.shape, generator=g, device=cuda)
    got = torch.autograd.grad((y * w).sum(), (a, b))
    want = torch.autograd.grad((ref * w).sum(), (a, b))
    for x, r in zip(got, want):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x.float(), r.float(), **TOL[torch.bfloat16])
