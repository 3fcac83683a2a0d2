"""The port's audio and vlm families (MusicGen, LLaVA-NeXT) against the JAX
package, on the CPU.

Both are the dense block wiring over a prefix of stub-frontend embeddings
prepended to the tokens.  The reduced musicgen-large (MHA 4/4) and
llava-next-mistral-7b (GQA 4/1), 8 prefix embeddings each, run on weights
drawn by the reference's ``init_model`` and carried over with
``lm_params_from_numpy``; tokens and prefixes are drawn with NumPy (the
reference's ``jax.random`` draw of a stub prefix cannot be matched, so the
same prefix goes to both).  On CPU tensors the ``swa_attention`` wrapper
runs its plain version (the CUDA kernel is held against it on the card).
Tolerances: float32 atol 2e-5 / rtol 1e-4 for losses and gradients; 1e-4
for logits; greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import multimodal as JMM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import multimodal as MM
from repro_torch.models import transformer as T

TOL = dict(atol=2e-5, rtol=1e-4)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("musicgen-large", "llava-next-mistral-7b")


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


def _tokens(seed, vocab, B, T_len):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T_len)
                                                ).astype(np.int32)


def _prefix(seed, cfg, B):
    """A stub prefix of the reference's scale (N(0, 0.02²)), from NumPy."""
    return (np.random.default_rng(seed).normal(size=(B, cfg.n_prefix_tokens,
                                                     cfg.d_model)) * 0.02
            ).astype(np.float32)


_MODELS = {}


def _models(arch):
    """(port cfg, reference cfg, port model on the CPU, reference params) of
    the reduced ``arch``, the same weights in both; built once."""
    if arch not in _MODELS:
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        params = JT.init_model(jax.random.PRNGKey(0), jcfg)
        model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                             cfg, "cpu")
        _MODELS[arch] = (cfg, jcfg, model, params)
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# configs and the stub frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert not mine.is_attention_free and mine.supports_long_context
        swa = mine.with_sliding_window(64)
        assert dataclasses.asdict(swa) == dataclasses.asdict(ref.with_sliding_window(64))
    red = get_config(arch).reduced()
    assert red.n_prefix_tokens == 8 and red.cdtype == torch.float32


@pytest.mark.parametrize("arch,counted", [("musicgen-large", 3_229_812_736),
                                          ("llava-next-mistral-7b", 7_241_732_096)])
def test_param_counts_match_the_reference_at_full_size(arch, counted):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count() == counted
    assert T.param_count(cfg) == JT.param_count(jcfg) == counted


def test_param_count_formula_of_every_family():
    """The config's analytic count is the reference's for every arch,
    recurrentgemma-2b's approximate hybrid formula included."""
    from repro.configs import ASSIGNED
    for arch in ASSIGNED + ("paper-char-lm",):
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_shape(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert MM.prefix_shape(cfg, 3) == JMM.prefix_shape(jcfg, 3) == (
        3, cfg.n_prefix_tokens, cfg.d_model)
    with pytest.raises(ValueError, match="no stub frontend"):
        MM.prefix_shape(get_config("qwen3-8b"), 1)


@pytest.mark.parametrize("hw", [(336, 336), (672, 672), (336, 1008), (1000, 1000),
                                (200, 3000), (1, 1)])
def test_anyres_tile_count(hw):
    assert MM.anyres_tile_count(hw) == JMM.anyres_tile_count(hw)
    assert MM.anyres_tile_count(hw, tile=224, patches_per_tile=256, max_tiles=6) == \
        JMM.anyres_tile_count(hw, tile=224, patches_per_tile=256, max_tiles=6)


def test_anyres_worst_case_is_the_configs_prefix():
    assert MM.anyres_tile_count((672, 672)) == 2880 == \
        get_config("llava-next-mistral-7b").n_prefix_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_make_stub_prefix(arch):
    """The shape, the config's compute dtype (or the one asked for), the
    reference's scale, and the same draw from the same seed."""
    cfg = get_config(arch).reduced()
    a = MM.make_stub_prefix(torch.Generator().manual_seed(1), cfg, 3, device="cpu")
    b = MM.make_stub_prefix(torch.Generator().manual_seed(1), cfg, 3, device="cpu",
                            dtype=torch.bfloat16)
    assert a.shape == (3, 8, cfg.d_model) and a.dtype == torch.float32
    assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)
    assert abs(float(a.std()) - 0.02) < 0.002
    full = get_config(arch)
    c = MM.make_stub_prefix(torch.Generator().manual_seed(1), full, 1, device="cpu")
    assert c.shape == (1, full.n_prefix_tokens, full.d_model)
    assert c.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the reduced models with a prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_is_the_layer_stacked_pytree(arch):
    cfg, _, model, params = _models(arch)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == leaves
    assert leaves["layers.attn.wk"] == (cfg.n_layers, cfg.d_model,
                                        cfg.n_kv_heads * cfg.d_head)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("with_prefix", [True, False])
def test_forward_matches_the_reference(arch, with_prefix):
    """Logits of the text positions only, the prefix conditioning them."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(1, cfg.vocab_size, 2, 20)
    pre = _prefix(2, cfg, 2) if with_prefix else None
    logits = T.forward(model, cfg, torch.as_tensor(toks),
                       prefix_embeds=None if pre is None else torch.as_tensor(pre))
    jlogits, _ = jax.jit(lambda p_, t_, x_: JT.forward(p_, jcfg, t_, x_))(
        params, jnp.asarray(toks), None if pre is None else jnp.asarray(pre))
    assert logits.shape == (2, 20, cfg.vocab_size)
    _close(logits, jlogits, LOGITS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_prefix_conditions_the_logits(arch):
    cfg, _, model, _ = _models(arch)
    toks = torch.as_tensor(_tokens(1, cfg.vocab_size, 2, 20))
    plain = T.forward(model, cfg, toks)
    cond = T.forward(model, cfg, toks,
                     prefix_embeds=torch.as_tensor(_prefix(2, cfg, 2) * 50))
    assert float((plain - cond).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_prefill_and_decode_chain(arch):
    """Prefill of the 8-embedding prefix and 24 tokens, then 6 decode
    steps from position P + T, logits compared at every step, and the
    cache's keys."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(3, cfg.vocab_size, 2, 24)
    pre = _prefix(4, cfg, 2)
    P = cfg.n_prefix_tokens
    cache_len = P + 24 + 8
    lg, st = T.prefill(model, cfg, torch.as_tensor(toks), cache_len,
                       prefix_embeds=torch.as_tensor(pre))
    jlg, jst = jax.jit(lambda p, t, x: JT.prefill(p, jcfg, t, cache_len,
                                                  prefix_embeds=x))(
        params, jnp.asarray(toks), jnp.asarray(pre))
    _close(lg, jlg, LOGITS_TOL)
    full = T.forward(model, cfg, torch.as_tensor(toks),
                     prefix_embeds=torch.as_tensor(pre))
    _close(lg, full[:, -1], LOGITS_TOL)
    jdec = jax.jit(lambda p, tok, s, pos: JT.decode_step(p, jcfg, tok, s, pos))
    nxt = _tokens(5, cfg.vocab_size, 6, 2)
    for i in range(6):
        lg, st = T.decode_step(model, cfg, torch.as_tensor(nxt[i]), st, P + 24 + i)
        jlg, jst = jdec(params, jnp.asarray(nxt[i]), jst, jnp.int32(P + 24 + i))
        _close(lg, jlg, LOGITS_TOL)
    _close(torch.stack([c.k for c in st]), jst.k)
    np.testing.assert_array_equal(_np(st[0].positions), _np(jst.positions[0]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("logit_chunk", [None, 7])
def test_lm_loss_with_a_prefix_matches_the_reference(arch, logit_chunk):
    """The loss over the text positions (the prefix stripped before the
    shift), from the module and from one worker's flat dict; chunked with
    a remainder (T − 1 = 19)."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(6, cfg.vocab_size, 2, 20)
    pre = _prefix(7, cfg, 2)
    ref = jax.jit(lambda p_, t_, x_: JT.lm_loss(
        p_, jcfg, {"tokens": t_, "prefix": x_}, logit_chunk=logit_chunk))(
            params, jnp.asarray(toks), jnp.asarray(pre))
    batch = {"tokens": torch.as_tensor(toks), "prefix": torch.as_tensor(pre)}
    _close(T.lm_loss(model, cfg, batch, logit_chunk=logit_chunk), ref)
    flat = convert.lm_flat_params_from_numpy(jax.tree.map(np.asarray, params),
                                             cfg, "cpu")
    _close(T.lm_loss(flat, cfg, batch, logit_chunk=logit_chunk), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_of_lm_loss_with_a_prefix_matches_jax_grad(arch):
    """``torch.func.grad`` over the flat dict and the prefix against
    ``jax.grad`` of the reference, leaf by leaf."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(8, cfg.vocab_size, 2, 16)
    pre = _prefix(9, cfg, 2)
    jg, jgx = jax.jit(jax.grad(lambda p, x: JT.lm_loss(
        p, jcfg, {"tokens": jnp.asarray(toks), "prefix": x}), argnums=(0, 1)))(
            params, jnp.asarray(pre))
    g, gx = torch.func.grad(lambda p, x: T.lm_loss(
        p, cfg, {"tokens": torch.as_tensor(toks), "prefix": x}), argnums=(0, 1))(
            T.flat_params(model), torch.as_tensor(pre))
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jg)}
    assert set(g) == set(ref)
    for k in ref:
        _close(g[k], ref[k])
    assert float(gx.abs().max()) > 0
    _close(gx, jgx)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_tokens_match_the_reference(arch):
    """Reduced musicgen / llava behind both servers (tokens only, as the
    reference's server): 5 requests of 3-17 tokens in 2-slot waves, 6
    greedy tokens each."""
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
def test_serve_cli_runs(arch, capsys):
    assert serve.main(["--arch", arch, "--demo", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
