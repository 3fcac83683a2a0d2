"""The port's production training launcher against the JAX package (CPU).

``launch/steps.py``'s ``build_train_step`` and ``python -m
repro_torch.launch.train``, with what they stand on: the training
forward's ``blockwise_attention`` and chunked RG-LRU scan, ``lm_loss`` of
every family with and without ``remat``, and the kernel wrappers' refusal
of anything autograd or ``torch.func`` tracks.  Inputs are drawn with NumPy
(weights by the reference's ``init_model``) and go through both packages.
Tolerance: float32 atol 2e-5 / rtol 1e-4 (the same function summed in
another order); gradients are held relative to their leaf's largest entry.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import sharding as JS
from repro.launch import steps as JST
from repro.launch.mesh import hierarchical_view
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.utils.compat import auto_axis_types, make_mesh
from repro_torch.configs import get_config
from repro_torch.kernels.gossip_mix import ops as gossip_ops
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.sparse_gossip import ops as sparse_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the test runner's parallel workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, **tol):
    np.testing.assert_allclose(_np(port), _np(ref), **(tol or TOL))


def _close_grad(port, ref):
    """A gradient within atol 2e-5 of its leaf's largest entry (the leaves'
    scales span orders of magnitude)."""
    ref = _np(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(port), ref, atol=2e-5 * scale, rtol=1e-4)


def _flat(tree):
    out = {}
    convert._flatten(jax.tree.map(np.asarray, tree), "", out)
    return out


# ---------------------------------------------------------------------------
# blockwise attention and the training scan
# ---------------------------------------------------------------------------

_ATTN_CASES = [
    (37, 4, 2, None),    # ragged T, GQA, causal frontier
    (37, 4, 2, 5),       # ragged T, a window inside one block
    (64, 2, 1, 13),      # whole blocks, a window across two
    (40, 6, 6, 17),      # MHA, ragged
]


@pytest.mark.parametrize("T_len,H,KV,window,fused", [
    pytest.param(*case, False, id="-".join(map(str, case)))
    for case in _ATTN_CASES] + [
    pytest.param(*case, True, id="fused-" + "-".join(map(str, case)))
    for case in _ATTN_CASES])
def test_blockwise_attention_matches_the_reference(T_len, H, KV, window,
                                                   fused):
    """``blockwise_attention`` (blocks of 8), and with ``fused`` the plain
    version of the training kernels (``swa_attention_train`` on CPU
    tensors: forward with the log-sum-exp, the backward from O, LSE and D,
    P and dS split hi + lo), against the reference's blockwise attention
    and ``jax.grad``; the fused version's gradients also against
    ``blockwise_attention``'s autograd ones, and rematerialised."""
    rng = np.random.default_rng(T_len + H)
    q = rng.standard_normal((2, T_len, H, 8)).astype(np.float32)
    k = rng.standard_normal((2, T_len, KV, 8)).astype(np.float32)
    v = rng.standard_normal((2, T_len, KV, 8)).astype(np.float32)
    w = rng.standard_normal((2, T_len, H, 8)).astype(np.float32)

    @jax.jit
    def ref(q, k, v):
        return JL.blockwise_attention(q, k, v, window=window, block_q=8,
                                      block_k=8)

    def blockwise(q, k, v):
        return L.blockwise_attention(q, k, v, window=window, block_q=8,
                                     block_k=8)

    def attend(q, k, v):
        return (swa_ops.swa_attention_train(q, k, v, window=window) if fused
                else blockwise(q, k, v))

    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attend(qt, kt, vt)
    _close(out, ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    jg = jax.jit(jax.grad(lambda *a: (ref(*a) * w).sum(), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tg = torch.autograd.grad((out * torch.as_tensor(w)).sum(), (qt, kt, vt))
    for a, b in zip(tg, jg):
        _close_grad(a, b)
    # it computes the plain attention's function
    pos = torch.arange(T_len)
    _close(out, L._plain_attention(qt, kt, vt, pos, pos, window))
    if fused:
        bg = torch.autograd.grad(
            (blockwise(qt, kt, vt) * torch.as_tensor(w)).sum(), (qt, kt, vt))
        for a, b in zip(tg, bg):
            _close_grad(a, b)
        rout = L.rematerialise(attend, qt, kt, vt)
        rg = torch.autograd.grad((rout * torch.as_tensor(w)).sum(),
                                 (qt, kt, vt))
        for a, b in zip(rg, tg):
            assert torch.equal(a, b)


def _attn_cfg(dh, dtype):
    import types
    return types.SimpleNamespace(d_model=32, n_heads=4, n_kv_heads=2,
                                 d_head=dh, qk_norm=False, rope_theta=1e4,
                                 norm_eps=1e-6, pdtype=dtype)


@pytest.mark.parametrize("case", ["cpu_bf16", "float32", "dh256", "torch_func"])
def test_apply_attention_keeps_blockwise_where_the_kernels_cannot_run(case):
    """Past T = 2·block the training forward's attention takes the kernels
    only for bf16 CUDA tensors of head width 64 or 128 outside torch.func:
    a CPU bf16 tensor, float32, dh 256 and a torch.func wrapper keep
    ``blockwise_attention``, with its values, and count as blockwise."""
    dh, dt = {"cpu_bf16": (64, torch.bfloat16), "dh256": (256, torch.float32)
              }.get(case, (64, torch.float32))
    cfg = _attn_cfg(dh, dt)
    p = L.Attention(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    x = torch.randn(1, 40, 32, generator=torch.Generator().manual_seed(1)
                    ).to(dt)
    pos = torch.arange(40)

    def run(x):
        return L.apply_attention(p, cfg, x, pos, plain=True, block_size=8)[0]

    before = dict(L.ATTENTION_ROUTES)
    if case == "torch_func":
        out = torch.func.vmap(run)(x[None])[0]
        assert torch.func.grad(lambda x: run(x).float().sum())(x).shape == x.shape
        calls = 2
    else:
        out = run(x)
        calls = 1
    assert {k: n - before[k] for k, n in L.ATTENTION_ROUTES.items()} == {
        "attn_fused": 0, "attn_blockwise": calls, "attn_plain": 0}
    B, T = x.shape[:2]
    q = L.apply_rope((x @ p.wq).reshape(B, T, 4, dh), pos, cfg.rope_theta)
    k = L.apply_rope((x @ p.wk).reshape(B, T, 2, dh), pos, cfg.rope_theta)
    v = (x @ p.wv).reshape(B, T, 2, dh)
    ref = L.blockwise_attention(q, k, v, block_q=8, block_k=8)
    torch.testing.assert_close(out, ref.reshape(B, T, -1) @ p.wo, atol=0,
                               rtol=0)
    assert not L.fused_attention_applies(q)


@pytest.mark.parametrize("T_len", [3 * 256, 100])
def test_training_scan_matches_the_reference(T_len):
    """T = 768: three rematerialised chunks of 256; T = 100: one log-depth
    scan over the whole sequence.  Also the kernel's plain version."""
    rng = np.random.default_rng(T_len)
    a = rng.uniform(0.5, 0.999, (2, T_len, 16)).astype(np.float32)
    x = rng.standard_normal((2, T_len, 16)).astype(np.float32)
    w = rng.standard_normal((2, T_len, 16)).astype(np.float32)
    at, xt = torch.tensor(a, requires_grad=True), torch.tensor(x, requires_grad=True)
    h = R.rglru_train_scan(at, xt)
    _close(h, jax.jit(JR.rglru_scan)(jnp.asarray(a), jnp.asarray(x)))
    _close(h, scan_ops.linear_scan_plain(at.detach(), xt.detach()))
    jg = jax.jit(jax.grad(lambda a, x: (JR.rglru_scan(a, x) * w).sum(),
                          argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(x))
    tg = torch.autograd.grad((h * torch.as_tensor(w)).sum(), (at, xt))
    for p, r in zip(tg, jg):
        _close_grad(p, r)


# ---------------------------------------------------------------------------
# lm_loss of every family
# ---------------------------------------------------------------------------

_MODELS = {}


def _models(arch):
    """(port cfg, reference cfg, port flat params, reference params) of the
    reduced ``arch``, the same weights in both; built once."""
    if arch not in _MODELS:
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        params = JT.init_model(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (cfg, jcfg,
                         convert.lm_flat_params_from_numpy(tree, cfg, "cpu"),
                         params)
    return _MODELS[arch]


def _batch(cfg, seed, B, T_len):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T_len)).astype(np.int32)}
    if cfg.frontend:
        b["prefix"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch,T_len", [
    ("recurrentgemma-2b", 40), ("recurrentgemma-2b", 1280),
    ("minicpm-2b", 40), ("grok-1-314b", 40), ("rwkv6-1.6b", 40),
    ("musicgen-large", 24), ("llava-next-mistral-7b", 24)])
def test_lm_loss_and_grad_match_the_reference(arch, T_len, remat):
    """Value and every leaf's gradient of ``lm_loss`` over a flat dict,
    through ``torch.autograd.grad`` as ``build_train_step`` takes it,
    against ``jax.value_and_grad``; CE in chunks of 7 with a remainder
    (256 at T = 1280, where attention turns blockwise (T > 1024) and the
    RG-LRU scan chunked (T % 256 = 0))."""
    cfg, jcfg, flat, params = _models(arch)
    chunk = 256 if T_len > 1024 else 7
    b = _batch(cfg, 3, 2, T_len)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(
        p, jcfg, jb, remat=remat, logit_chunk=chunk)))(params)
    ps = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss = T.lm_loss(ps, cfg, {k: torch.as_tensor(v) for k, v in b.items()},
                     logit_chunk=chunk, remat=remat)
    g = torch.autograd.grad(loss, list(ps.values()))
    _close(loss, jl)
    ref = _flat(jg)
    assert set(ref) == set(ps)
    for k, gi in zip(ps, g):
        _close_grad(gi, ref[k])


@pytest.mark.parametrize("arch,T_len", [("minicpm-2b", 1100),
                                        ("recurrentgemma-2b", 1280)])
def test_lm_loss_without_remat_is_torch_func_differentiable_at_any_length(
        arch, T_len):
    """The decentralized trainer takes ``vmap(grad(lm_loss))``, and
    ``torch.func`` cannot carry a checkpoint.  Past T = 1024 attention is
    blockwise (and at T % 256 = 0 the RG-LRU scan chunked); without
    ``remat`` neither is checkpointed, so ``vmap(grad)`` over two workers'
    batches gives ``torch.autograd.grad``'s gradients of ``remat=True``."""
    cfg, _, flat, _ = _models(arch)
    tokens = torch.as_tensor(np.stack(
        [_batch(cfg, 5 + w, 1, T_len)["tokens"] for w in range(2)]))
    chunk = 256
    g = torch.func.vmap(torch.func.grad(
        lambda p, t: T.lm_loss(p, cfg, {"tokens": t}, logit_chunk=chunk)),
        in_dims=(None, 0))(flat, tokens)
    for w in range(2):
        ps = {k: v.clone().requires_grad_() for k, v in flat.items()}
        ref = torch.autograd.grad(
            T.lm_loss(ps, cfg, {"tokens": tokens[w]}, logit_chunk=chunk,
                      remat=True), list(ps.values()))
        for k, r in zip(ps, ref):
            _close_grad(g[k][w], r)


def test_hybrid_lm_loss_takes_the_module_or_a_dict():
    cfg, _, flat, params = _models("recurrentgemma-2b")
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                         "cpu")
    b = {"tokens": torch.as_tensor(_batch(cfg, 4, 1, 20)["tokens"])}
    assert float(T.lm_loss(model, cfg, b)) == float(T.lm_loss(flat, cfg, b))


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------

def _wrapper_calls(x2, ix):
    """Each CUDA wrapper with operands built from ``x2`` (a (4, 8) float
    tensor); ``ix`` is an int32 index vector."""
    P = x2[:, :4].contiguous()
    return {
        "masked_gossip": lambda: gossip_ops.masked_gossip_cuda(x2, x2, P, P),
        "gossip_mix": lambda: gossip_ops.gossip_mix_cuda(x2, P),
        "gossip_mix_batched": lambda: gossip_ops.gossip_mix_batched_cuda(
            x2[None], P[None]),
        "sparse_gossip": lambda: sparse_ops.sparse_gossip_cuda(
            x2, x2, P, P, ix),
        "scatter_rows": lambda: sparse_ops.scatter_rows_cuda(x2, x2, ix),
        "linear_scan": lambda: scan_ops.linear_scan_cuda(x2[None], x2[None]),
        "swa_attention": lambda: swa_ops.swa_attention_cuda(
            x2[None], x2[None], x2[None], window=2),
        "swa_attention_train": lambda: swa_ops.swa_attention_train_fwd_cuda(
            x2[None, :, None], x2[None, :, None], x2[None, :, None], window=2),
        "swa_attention_bwd": lambda: swa_ops.swa_attention_train_bwd_cuda(
            *(x2[None, :, None],) * 5, x2[None, None, :, 0], window=2),
    }


@pytest.mark.parametrize("kernel", ["masked_gossip", "gossip_mix",
                                    "gossip_mix_batched", "sparse_gossip",
                                    "scatter_rows", "linear_scan",
                                    "swa_attention", "swa_attention_train",
                                    "swa_attention_bwd"])
def test_cuda_wrappers_refuse_operands_that_require_grad(kernel):
    """On CPU tensors the refusal comes before the device check: a
    differentiable caller learns that the kernel has no backward, not that
    it is on the wrong device."""
    gen = torch.Generator().manual_seed(0)
    ix = torch.arange(4, dtype=torch.int32)
    x = torch.randn(4, 8, generator=gen, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{kernel}: .*no backward"):
        _wrapper_calls(x, ix)[kernel]()
    # under torch.func the operands are wrappers, whatever requires_grad says
    with pytest.raises(RuntimeError, match=f"{kernel}: .*no backward"):
        torch.func.grad(lambda y: (_wrapper_calls(y, ix)[kernel](), y.sum())[1])(
            torch.randn(4, 8, generator=gen))
    # without autograd the device check speaks, as before
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            _wrapper_calls(x, ix)[kernel]()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_assigned_archs_are_the_reference_s():
    from repro.configs import ASSIGNED as JAX_ASSIGNED
    from repro_torch.configs import ASSIGNED
    assert ASSIGNED == JAX_ASSIGNED


def test_ring_matrix_is_the_reference_ring():
    w4 = ST.default_gossip_weights(4, False)
    P = ST.ring_matrix(4, w4)
    third = torch.tensor(1 / 3)
    for j in range(4):
        assert P[j, j] == P[(j - 1) % 4, j] == P[(j + 1) % 4, j] == third
    assert torch.equal(P.sum(0), P.sum(1))                # doubly stochastic
    P2 = ST.ring_matrix(2, ST.default_gossip_weights(2, False))
    assert P2.tolist() == [[0.5, 0.5], [0.5, 0.5]]        # left + right meet
    assert ST.ring_matrix(1, ST.default_gossip_weights(1, False)).tolist() == [[1.0]]
    straggle = dict(w4, left=torch.tensor(0.0), right=torch.tensor(0.0),
                    self=torch.tensor(1.0))
    assert torch.equal(ST.ring_matrix(4, straggle), torch.eye(4))
    # one pod: the pod weight is not read, as the reference reads it only on
    # a mesh with a pod axis; two pods of two: (1 − 1/4)·blockdiag(R, R) +
    # 1/4·swap (held against the reference's pod gossip in
    # test_torch_launch.py)
    assert torch.equal(ST.ring_matrix(4, ST.default_gossip_weights(4, True)), P)
    assert ST.ring_matrix(4, ST.default_gossip_weights(2, True), pods=2).tolist() == [
        [0.375, 0.375, 0.25, 0.0], [0.375, 0.375, 0.0, 0.25],
        [0.25, 0.0, 0.375, 0.375], [0.0, 0.25, 0.375, 0.375]]
    assert set(ST.gossip_weights_spec()) == set(JST.gossip_weights_spec())


def _jax_step(jcfg, n, logit_chunk):
    """The reference's jitted train step on an (n,)-device worker mesh."""
    base = make_mesh((n, 1), ("data", "model"), axis_types=auto_axis_types(2))
    mesh, axes = hierarchical_view(base, n, 1)
    init = JST.stacked_init(jcfg, n)
    sds = jax.eval_shape(init, jax.random.PRNGKey(0))
    pspecs = JS.param_pspecs(sds, mesh, fsdp=axes.fsdp, model=axes.model,
                             worker_axes=axes.worker_axes)
    return mesh, init, jax.jit(JST.build_train_step(
        jcfg, n, axes, mesh, pspecs, logit_chunk=logit_chunk))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "musicgen-large"])
def test_train_step_at_one_worker_matches_the_reference(arch):
    """N = 1 in process, the reference's W injected from NumPy; musicgen
    with its zero stub prefix, as the CLI feeds it."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    mesh, init, jstep = _jax_step(jcfg, 1, 16)
    W = init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2, 64)
                                             ).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend:
        batch["prefix"] = np.zeros((1, 2, cfg.n_prefix_tokens, cfg.d_model),
                                   np.float32)
    with mesh:
        W2, jl = jstep(W, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.float32(0.05), JST.default_gossip_weights(1, False))
    Wt = {k: torch.from_numpy(np.array(v)) for k, v in _flat(W).items()}
    step = ST.build_train_step(cfg, 1, logit_chunk=16, device="cpu")
    Wt2, loss = step(Wt, {k: torch.as_tensor(v) for k, v in batch.items()},
                     0.05, ST.default_gossip_weights(1, False))
    assert Wt2 is Wt                                      # updated in place
    _close(loss, jl)
    ref = _flat(W2)
    assert set(ref) == set(Wt2)
    for k in ref:
        _close(Wt2[k], ref[k])


def test_microbatches_average_the_gradients():
    """Two microbatches of one sequence each: the mean of their float32
    gradients, which in float32 is the whole batch's gradient."""
    cfg = get_config("minicpm-2b").reduced()
    W0 = ST.stacked_init(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 2, 32)).astype(np.int32))
    gw = ST.default_gossip_weights(1, False)
    outs = []
    for mb in (1, 2):
        W = {k: v.clone() for k, v in W0.items()}
        step = ST.build_train_step(cfg, 1, microbatch=mb, logit_chunk=8,
                                   device="cpu")
        outs.append(step(W, {"tokens": toks}, 0.05, gw))
    (Wa, la), (Wb, lb) = outs
    _close(la, lb)
    for k in Wa:
        _close(Wa[k], Wb[k])


def test_serve_and_prefill_steps_are_the_model_entry_points():
    cfg, _, flat, _ = _models("recurrentgemma-2b")
    toks = torch.as_tensor(_batch(cfg, 6, 2, 12)["tokens"])
    logits, state = ST.build_prefill_step(cfg, 16)(flat, {"tokens": toks})
    ref, _ = T.prefill(flat, cfg, toks, 16)
    assert torch.equal(logits, ref)
    nxt = logits.argmax(-1)
    lg, _ = ST.build_serve_step(cfg)(flat, nxt, state, 12)
    assert lg.shape == (2, cfg.vocab_size) and torch.isfinite(lg).all()


_FOUR_WORKERS = """
import jax, jax.numpy as jnp, numpy as np, torch
torch.set_num_threads(1)
from repro.configs import get_config as jax_get_config
from repro.launch import steps as JST
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
import test_torch_train as t

for arch in ("recurrentgemma-2b", "minicpm-2b"):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    mesh, init, jstep = t._jax_step(jcfg, 4, 16)
    W = init(jax.random.PRNGKey(2))
    Wt = {k: torch.from_numpy(np.array(v)) for k, v in t._flat(W).items()}
    step = ST.build_train_step(cfg, 4, logit_chunk=16, device="cpu")
    ring = JST.default_gossip_weights(4, False)
    straggle = dict(ring, left=jnp.float32(0), right=jnp.float32(0),
                    self=jnp.float32(1))
    rng = np.random.default_rng(3)
    for name, gw in (("ring", ring), ("straggler", straggle)):
        toks = rng.integers(0, cfg.vocab_size, (4, 2, 48)).astype(np.int32)
        with mesh:
            W, jl = jstep(W, {"tokens": jnp.asarray(toks)}, jnp.float32(0.05), gw)
        Wt, loss = step(Wt, {"tokens": torch.as_tensor(toks)}, 0.05,
                        {k: torch.tensor(float(v)) for k, v in gw.items()})
        ref = t._flat(W)
        err = max(float(np.abs(Wt[k].numpy() - ref[k]).max()
                        / max(1.0, np.abs(ref[k]).max())) for k in ref)
        print(arch, name, "W", err, "loss", abs(float(loss) - float(jl)),
              "spread", max(float(np.abs(ref[k][0] - ref[k][1]).max())
                            for k in ref))
"""


def test_train_step_at_four_workers_matches_the_reference():
    """N = 4 host devices in a subprocess (the reference's ``ppermute``
    ring needs them): reduced recurrentgemma-2b and minicpm-2b in float32,
    one ring step then one straggler step (P = I), from one W0.  The
    workers see different tokens, so their parameters part and the ring
    mixes distinct rows."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_FOUR_WORKERS)],
                         capture_output=True, text=True, env=env, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln.split() for ln in out.stdout.splitlines() if ln.strip()]
    assert [ln[:2] for ln in lines] == [
        [a, s] for a in ("recurrentgemma-2b", "minicpm-2b")
        for s in ("ring", "straggler")]
    for ln in lines:
        w_err, loss_err, spread = float(ln[3]), float(ln[5]), float(ln[7])
        assert w_err <= 2e-5 and loss_err <= 2e-5, ln
        assert spread > 1e-3, ln


# ---------------------------------------------------------------------------
# python -m repro_torch.launch.train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b"])
def test_train_cli_demo(arch, tmp_path, capsys):
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    rc = train.main(["--arch", arch, "--demo", "--steps", "2", "--seq", "32",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out[:2]] == [["step", "0"], ["step", "1"]]
    assert out[-1] == "done"
    # the reference's checkpointer restores the CLI's last step
    like = jax.eval_shape(JST.stacked_init(jax_get_config(arch).reduced(), 2),
                          jax.random.PRNGKey(0))
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), like)
    ck = JaxCheckpointer(str(tmp_path))
    assert ck.all_steps() == [1, 2]
    tree, extra = ck.restore(like)
    assert extra == {"stream": {"cursor": [2, 2]}}
    assert all(np.isfinite(np.asarray(v)).all() for v in jax.tree.leaves(tree))
    one = ck.restore_worker_slice(jax.tree.map(lambda x: x[0], like), 1)
    assert jax.tree.map(np.shape, one) == jax.tree.map(lambda x: x.shape[1:], like)


def test_train_cli_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "minicpm-2b", "--demo", "--steps", "1"])
    with pytest.raises(ValueError, match="odd"):
        train.main(["--arch", "minicpm-2b", "--demo", "--multipod",
                    "--workers", "3", "--device", "cpu"])
    # two pods of two workers, stacked on the CPU (the two-pod matrix is
    # held to the reference in test_torch_launch.py)
    assert train.main(["--arch", "minicpm-2b", "--demo", "--multipod",
                       "--workers", "4", "--steps", "1", "--seq", "32",
                       "--device", "cpu"]) == 0
