"""The port's dense LM family against the JAX package, on the CPU.

The five dense configs (qwen3-8b, minicpm-2b, mistral-nemo-12b,
deepseek-67b, paper-char-lm), each reduced with the rules both packages
share, run on weights drawn by the reference's ``init_model`` and carried
over with ``lm_params_from_numpy``; tokens are drawn with NumPy.  On CPU
tensors the ``swa_attention`` wrapper runs its plain version (the CUDA
kernel is held against it on the card).  Tolerance: float32 atol 2e-5 /
rtol 1e-4 -- the same function summed in another order (the reference's
blockwise softmax past T = 1024 against the port's one-pass softmax, and
the gradients' sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import transformer as T

TOL = dict(atol=2e-5, rtol=1e-4)
ARCHS = ("qwen3-8b", "minicpm-2b", "mistral-nemo-12b", "deepseek-67b",
         "paper-char-lm")


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


def _close(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), **TOL)


_MODELS = {}


def _models(arch):
    """(port cfg, reference cfg, port model on the CPU, reference params)
    of the reduced ``arch``, the same weights in both; built once."""
    if arch not in _MODELS:
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        params = JT.init_model(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (cfg, jcfg, convert.lm_params_from_numpy(tree, cfg, "cpu"),
                         params)
    return _MODELS[arch]


def _tokens(seed, vocab, B, T_len):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T_len)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).reduced(), jax_get_config(arch).reduced())):
        ref_fields = dataclasses.asdict(ref)
        assert dataclasses.asdict(mine) == {k: ref_fields[k]
                                            for k in dataclasses.asdict(mine)}
        # the reference's options the port has no field for are all off
        assert (ref.n_experts, ref.frontend, ref.n_prefix_tokens,
                ref.block_pattern) == (0, None, 0, ())
    assert get_config(arch).reduced().cdtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_reference_at_full_size(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count() == JT.param_count(jcfg)
    assert T.param_count(cfg) == JT.param_count(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_is_the_layer_stacked_pytree(arch):
    cfg, _, model, params = _models(arch)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == leaves
    assert leaves["layers.attn.wq"] == (cfg.n_layers, cfg.d_model,
                                        cfg.n_heads * cfg.d_head)
    assert ("layers.attn.q_norm.scale" in leaves) == cfg.qk_norm
    assert ("head.w" in leaves) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_chain(arch):
    """Full logits, then prefill of 24 tokens and a chain of 6 decode
    steps, logits compared at every step."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(3, cfg.vocab_size, 2, 24)
    logits = T.forward(model, cfg, torch.as_tensor(toks))
    jlogits, _ = jax.jit(lambda p_, t_: JT.forward(p_, jcfg, t_))(
        params, jnp.asarray(toks))
    assert logits.shape == (2, 24, cfg.vocab_size)
    _close(logits, jlogits)

    cache_len = 32
    lg, st = T.prefill(model, cfg, torch.as_tensor(toks), cache_len)
    jlg, jst = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, cache_len))(
        params, jnp.asarray(toks))
    _close(lg, jlg)
    _close(lg, logits[:, -1])
    jdec = jax.jit(lambda p, tok, s, pos: JT.decode_step(p, jcfg, tok, s, pos))
    nxt = _tokens(4, cfg.vocab_size, 6, 2)
    for i in range(6):
        lg, st = T.decode_step(model, cfg, torch.as_tensor(nxt[i]), st, 24 + i)
        jlg, jst = jdec(params, jnp.asarray(nxt[i]), jst, jnp.int32(24 + i))
        _close(lg, jlg)
    # the caches: the reference's stacked (L, B, size, KV, dh) against the
    # port's per-layer tuple
    _close(torch.stack([c.k for c in st]), jst.k)
    np.testing.assert_array_equal(_np(st[0].positions), _np(jst.positions[0]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("logit_chunk", [None, 7])
def test_lm_loss_matches_the_reference(arch, logit_chunk):
    """The loss from the module and from one worker's flat dict; chunked
    with a remainder (T − 1 = 39 = 5·7 + 4)."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(5, cfg.vocab_size, 2, 40)
    ref = JT.lm_loss(params, jcfg, {"tokens": jnp.asarray(toks)},
                     logit_chunk=logit_chunk)
    batch = {"tokens": torch.as_tensor(toks)}
    _close(T.lm_loss(model, cfg, batch, logit_chunk=logit_chunk), ref)
    _close(T.lm_loss(T.flat_params(model), cfg, batch,
                     logit_chunk=logit_chunk), ref)


def test_lm_loss_past_the_reference_blockwise_switch():
    """T = 1100: the training forward's attention turns blockwise
    (T > 1024) in both packages."""
    cfg, jcfg, model, params = _models("qwen3-8b")
    toks = _tokens(6, cfg.vocab_size, 1, 1100)
    ref = JT.lm_loss(params, jcfg, {"tokens": jnp.asarray(toks)},
                     logit_chunk=256)
    _close(T.lm_loss(model, cfg, {"tokens": torch.as_tensor(toks)},
                     logit_chunk=256), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_of_lm_loss_matches_jax_grad(arch):
    """``torch.func.grad`` over one worker's flat dict, as the trainer takes
    it, against ``jax.grad`` of the reference, leaf by leaf."""
    cfg, jcfg, model, params = _models(arch)
    toks = _tokens(7, cfg.vocab_size, 2, 20)
    jg = jax.grad(lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)}))(
        params)
    g = torch.func.grad(lambda p: T.lm_loss(p, cfg, {"tokens": torch.as_tensor(toks)}))(
        T.flat_params(model))
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jg)}
    assert set(g) == set(ref)
    for k in ref:
        _close(g[k], ref[k])


def test_batched_server_tokens_match_the_reference():
    """Reduced qwen3 behind both servers: 5 requests of 3-17 tokens in
    2-slot waves, 6 greedy tokens each."""
    cfg, jcfg, model, params = _models("qwen3-8b")
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


def test_serve_cli_runs_a_dense_arch(capsys):
    assert serve.main(["--arch", "qwen3-8b", "--demo", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
