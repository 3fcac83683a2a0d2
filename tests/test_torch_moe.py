"""The port's MoE family (grok-1, arctic) against the JAX package, on the CPU.

The MoE block (``repro_torch.models.moe``) runs on weights drawn by the
reference's ``init_moe`` and carried over with ``convert.load_numpy``; the
reduced grok-1-314b and arctic-480b (the rules both packages share) run on
weights drawn by the reference's ``init_model`` and carried over with
``lm_params_from_numpy``; activations and tokens are drawn with NumPy.  On
CPU tensors the ``swa_attention`` wrapper runs its plain version (the CUDA
kernel is held against it on the card).  Tolerances: float32 atol 2e-5 /
rtol 1e-4 for the block, its gates and aux loss, the losses and the
gradients (the same function summed in another order); 1e-4 for logits.
Expert choices, slots and drops are integers and must match exactly, which
the outputs show: one token sent elsewhere moves them by O(1).  A chain
compared with ``forward`` uses ``moe_capacity_factor=64``, since the
capacity depends on the number of tokens in the call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.launch import serve as jax_serve
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

TOL = dict(atol=2e-5, rtol=1e-4)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("grok-1-314b", "arctic-480b")


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


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _block_cfgs(**kw):
    """A small MoE block's config in both packages (float32)."""
    base = dict(name="moe-block", family="moe", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=48, vocab_size=64, n_experts=4,
                top_k=2, param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return ModelConfig(**base), JaxModelConfig(**base)


def _block(cfg, jcfg, seed=0):
    params = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    mod = convert.load_numpy(M.init_moe(cfg, None, "cpu"),
                             jax.tree.map(np.asarray, params))
    return mod, params


_MODELS = {}


def _models(arch, **over):
    """(port cfg, reference cfg, port model on the CPU, reference params) of
    the reduced ``arch`` with ``over`` replaced, the same weights in both;
    built once per arch (the overrides change no weight shape)."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch).reduced()
        params = JT.init_model(jax.random.PRNGKey(0), jcfg)
        model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                             get_config(arch).reduced(), "cpu")
        _MODELS[arch] = (model, params)
    model, params = _MODELS[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    return cfg, jcfg, model, params


def _tokens(seed, vocab, B, T_len):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T_len)
                                                ).astype(np.int32)


# ---------------------------------------------------------------------------
# gating and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_top_k_gating_matches_the_reference(top_k, ties):
    """Gates, expert indices and aux loss; with ``ties`` the logits sit on a
    coarse grid (and two rows are constant), so equal probabilities must go
    to the lower expert index first, as ``jax.lax.top_k`` orders them."""
    logits = _x(1, 40, 6)
    if ties:
        logits = np.round(logits * 2) / 2
        logits[3] = 0.5
        logits[7, :4] = 1.0
    gates, idx, aux = M._top_k_gating(torch.as_tensor(logits), top_k)
    jgates, jidx, jaux = JM._top_k_gating(jnp.asarray(logits), top_k)
    np.testing.assert_array_equal(_np(idx), _np(jidx))
    _close(gates, jgates)
    _close(aux, jaux)
    if ties:
        assert _np(idx)[3].tolist() == list(range(top_k))


def test_top_k_gating_runs_per_group():
    """A leading group axis: each group gated as the reference gates it."""
    logits = _x(2, 3, 16, 4)
    gates, idx, aux = M._top_k_gating(torch.as_tensor(logits), 2)
    for g in range(3):
        jgates, jidx, jaux = JM._top_k_gating(jnp.asarray(logits[g]), 2)
        np.testing.assert_array_equal(_np(idx[g]), _np(jidx))
        _close(gates[g], jgates)
        _close(aux[g], jaux)


# name -> (block config overrides, capacity factor passed to apply_moe)
BLOCK_CASES = {
    "ungrouped_k2": (dict(), None),
    "ungrouped_k1": (dict(top_k=1), None),
    "grouped_k2": (dict(moe_groups=2), None),          # N = 24 = 2 · 12
    "grouped_k1": (dict(moe_groups=3, top_k=1), None),
    "uneven_groups": (dict(moe_groups=5), None),       # 24 % 5 != 0: G = 1
    "small_groups": (dict(moe_groups=8), None),        # 24 / 8 < 4 experts: G = 1
    "dropping": (dict(), 0.01),                        # capacity 4 of 48 pairs
    "dropping_k1": (dict(top_k=1), 0.01),
    "dropping_grouped": (dict(moe_groups=2), 0.01),
    "config_capacity": (dict(moe_capacity_factor=0.5), None),
    "dense_residual": (dict(dense_residual_ff=24), None),
    "dense_residual_dropping": (dict(dense_residual_ff=24, moe_groups=2), 0.01),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_apply_moe_matches_the_reference(case):
    over, cf = BLOCK_CASES[case]
    cfg, jcfg = _block_cfgs(**over)
    mod, params = _block(cfg, jcfg, seed=len(case))
    x = _x(3, 2, 12, cfg.d_model)
    out, aux = M.apply_moe(mod, cfg, torch.as_tensor(x), capacity_factor=cf)
    jout, jaux = jax.jit(lambda p_, x_: JM.apply_moe(p_, jcfg, x_, capacity_factor=cf))(
        params, jnp.asarray(x))
    assert out.shape == (2, 12, cfg.d_model) and aux.shape == ()
    _close(out, jout)
    _close(aux, jaux)


def test_dropped_pairs_change_the_output():
    """The dropping cases do drop: at capacity factor 0.01 each of the 4
    experts keeps 4 of the 48 (token, choice) pairs, and the output moves
    away from the undropped one."""
    cfg, jcfg = _block_cfgs()
    mod, _ = _block(cfg, jcfg)
    x = torch.as_tensor(_x(3, 2, 12, cfg.d_model))
    full, _ = M.apply_moe(mod, cfg, x, capacity_factor=64.0)
    dropped, _ = M.apply_moe(mod, cfg, x, capacity_factor=0.01)
    assert max(4, int(0.01 * 2 * 24 / 4)) * cfg.n_experts < 24 * 2
    assert float((full - dropped).abs().max()) > 1e-2
    # a token none of whose choices fit gets exactly zero
    assert int((dropped.abs().sum(-1) == 0).sum()) > 0


def test_moe_module_keys_are_the_reference_pytree():
    cfg, jcfg = _block_cfgs(dense_residual_ff=24)
    mod, params = _block(cfg, jcfg)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == leaves
    assert leaves["w_gate"] == (4, 32, 48) and leaves["w_down"] == (4, 48, 32)
    assert leaves["dense_residual.w_up"] == (32, 24)


def test_init_draws_at_the_reference_scales():
    """The router at 0.02, the (E, d, f) expert leaves at 1/√E (the
    reference's fan-in is the leading axis), the dense residual at 1/√d;
    the experts drawn slice by slice straight into a bf16 parameter."""
    cfg, _ = _block_cfgs(d_model=128, d_ff=256, n_experts=16,
                         dense_residual_ff=64, param_dtype="bfloat16")
    mod = M.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    assert mod.w_gate.dtype == torch.bfloat16
    stds = {k: float(v.float().std()) for k, v in mod.state_dict().items()}
    assert abs(stds["router"] - 0.02) < 0.002
    for k in ("w_gate", "w_up", "w_down"):
        assert abs(stds[k] - 0.25) < 0.01, (k, stds[k])
    assert abs(stds["dense_residual.w_gate"] - 128 ** -0.5) < 0.005
    w = mod.w_gate.float()
    assert not torch.equal(w[0], w[1])
    stacked = M.MoE(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                    lead=(3,))
    assert stacked.w_gate.shape == (3, 16, 128, 256)
    assert not torch.equal(stacked.w_up[0], stacked.w_up[2])


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        ref_fields = dataclasses.asdict(ref)
        assert dataclasses.asdict(mine) == {k: ref_fields[k]
                                            for k in dataclasses.asdict(mine)}
        # the reference's options the port has no field for are all off
        assert (ref.frontend, ref.n_prefix_tokens, ref.block_pattern) == (None, 0, ())
    red = get_config(arch).reduced()
    assert (red.n_experts, red.top_k, red.moe_groups) == (4, 2, 1)
    assert red.cdtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference_at_full_size(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count() == JT.param_count(jcfg)
    assert T.param_count(cfg) == JT.param_count(jcfg)
    assert (cfg.active_param_count() == jcfg.active_param_count()
            == T.active_param_count(cfg) == JT.active_param_count(jcfg))
    assert T.active_param_count(cfg) < T.param_count(cfg)


def test_cut_depth_param_counts():
    """The depths served on one card: grok-1 at 4 layers, arctic at 2."""
    grok = dataclasses.replace(get_config("grok-1-314b"), n_layers=4)
    arctic = dataclasses.replace(get_config("arctic-480b"), n_layers=2)
    assert T.param_count(grok) == grok.param_count() == 21_290_539_008
    assert T.param_count(arctic) == arctic.param_count() == 27_681_131_520


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_is_the_layer_stacked_pytree(arch):
    cfg, _, model, params = _models(arch)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == leaves
    L, d, E, f = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    assert leaves["layers.ffn.router"] == (L, d, E)
    assert leaves["layers.ffn.w_gate"] == (L, E, d, f)
    assert leaves["layers.ffn.w_down"] == (L, E, f, d)
    assert ("layers.ffn.dense_residual.w_up" in leaves) == bool(cfg.dense_residual_ff)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
def test_forward_prefill_and_decode_chain(arch, groups):
    """Full logits and aux, then prefill of 24 tokens and a chain of 6
    decode steps, logits compared at every step (capacity factor 64: no
    drops, so prefill and forward agree; two dispatch groups take the
    grouped path in forward and prefill, N = 48)."""
    cfg, jcfg, model, params = _models(arch, moe_capacity_factor=64.0,
                                       moe_groups=groups)
    toks = _tokens(3, cfg.vocab_size, 2, 24)
    logits, aux = T.forward(model, cfg, torch.as_tensor(toks), with_aux=True)
    jlogits, jaux = jax.jit(lambda p_, t_: JT.forward(p_, jcfg, t_))(
        params, jnp.asarray(toks))
    assert logits.shape == (2, 24, cfg.vocab_size)
    _close(logits, jlogits, LOGITS_TOL)
    _close(aux, jaux)
    assert float(aux) > 0

    cache_len = 32
    lg, st = T.prefill(model, cfg, torch.as_tensor(toks), cache_len)
    jlg, jst = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, cache_len))(
        params, jnp.asarray(toks))
    _close(lg, jlg, LOGITS_TOL)
    _close(lg, logits[:, -1], LOGITS_TOL)
    jdec = jax.jit(lambda p, tok, s, pos: JT.decode_step(p, jcfg, tok, s, pos))
    nxt = _tokens(4, cfg.vocab_size, 6, 2)
    for i in range(6):
        lg, st = T.decode_step(model, cfg, torch.as_tensor(nxt[i]), st, 24 + i)
        jlg, jst = jdec(params, jnp.asarray(nxt[i]), jst, jnp.int32(24 + i))
        _close(lg, jlg, LOGITS_TOL)
    _close(torch.stack([c.k for c in st]), jst.k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
def test_forward_at_the_config_capacity(arch, groups):
    """The configs' own capacity factor (1.25) over 2 × 40 tokens, where
    the capacity binds: logits and aux as the reference's."""
    cfg, jcfg, model, params = _models(arch, moe_groups=groups)
    toks = _tokens(8, cfg.vocab_size, 2, 40)
    logits, aux = T.forward(model, cfg, torch.as_tensor(toks), with_aux=True)
    jlogits, jaux = jax.jit(lambda p_, t_: JT.forward(p_, jcfg, t_))(
        params, jnp.asarray(toks))
    _close(logits, jlogits, LOGITS_TOL)
    _close(aux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("logit_chunk", [None, 7])
def test_lm_loss_matches_the_reference(arch, logit_chunk):
    """The loss with its aux term (weight 0.01), from the module and from
    one worker's flat dict; chunked with a remainder (T − 1 = 39)."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(5, cfg.vocab_size, 2, 40)
    ref, ref_w = jax.jit(lambda p_, t_: (
        JT.lm_loss(p_, jcfg, {"tokens": t_}, logit_chunk=logit_chunk),
        JT.lm_loss(p_, jcfg, {"tokens": t_}, aux_weight=0.5)))(
            params, jnp.asarray(toks))
    batch = {"tokens": torch.as_tensor(toks)}
    _close(T.lm_loss(model, cfg, batch, logit_chunk=logit_chunk), ref)
    _close(T.lm_loss(T.flat_params(model), cfg, batch,
                     logit_chunk=logit_chunk), ref)
    _close(T.lm_loss(model, cfg, batch, aux_weight=0.5), ref_w)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_of_lm_loss_matches_jax_grad(arch):
    """``torch.func.grad`` over the flat dict against ``jax.grad`` of the
    reference, leaf by leaf: the router's gradient reaches it through the
    gates and through the aux loss's mean probabilities."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(7, cfg.vocab_size, 2, 20)
    jg = jax.jit(jax.grad(lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)})))(
        params)
    g = torch.func.grad(lambda p: T.lm_loss(p, cfg, {"tokens": torch.as_tensor(toks)}))(
        T.flat_params(model))
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jg)}
    assert set(g) == set(ref)
    assert float(g["layers.ffn.router"].abs().max()) > 0
    for k in ref:
        _close(g[k], ref[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_tokens_match_the_reference(arch):
    """Reduced grok-1 / arctic behind both servers: 5 requests of 3-17
    tokens in 2-slot waves, 6 greedy tokens each."""
    cfg, jcfg, model, params = _models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(3, 18, size=5)]
    outs = []
    for mod, weights, c in ((serve, model, cfg), (jax_serve, params, jcfg)):
        reqs = [mod.Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        mod.BatchedServer(c, weights, batch_slots=2, cache_len=32).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 6 for o in outs[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_an_moe_arch(arch, capsys):
    assert serve.main(["--arch", arch, "--demo", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--layers", "1"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out


def test_dense_forward_reports_no_aux():
    cfg = get_config("qwen3-8b").reduced()
    model = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(_tokens(1, cfg.vocab_size, 1, 8))
    logits, aux = T.forward(model, cfg, toks, with_aux=True)
    assert float(aux) == 0.0
    assert torch.equal(logits, T.forward(model, cfg, toks))
