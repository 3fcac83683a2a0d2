"""The port's hybrid LM (RecurrentGemma) against the JAX package, on the CPU.

Weights come from the reference's ``init_model`` and are carried over with
``lm_params_from_numpy``; activations and prompts are drawn with NumPy and
fed to both packages.  On CPU tensors the port's kernel wrappers run their
plain versions (the CUDA kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Tolerance: float32
atol 2e-5 / rtol 1e-4 -- the same function summed in another order (the
reference's associative scan and blockwise softmax against the port's
sequential scan and one-pass softmax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import layers as JL
from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T

TOL = dict(atol=2e-5, rtol=1e-4)
ARCH = "recurrentgemma-2b"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), **TOL)


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def models(cfgs):
    """(port model on the CPU, reference params) with the same weights."""
    cfg, jcfg = cfgs
    params = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return convert.lm_params_from_numpy(tree, cfg, "cpu"), params


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_configs_match_the_reference(cfgs):
    for full in (True, False):
        mine = get_config(ARCH) if full else cfgs[0]
        ref = jax_get_config(ARCH) if full else cfgs[1]
        ref_fields = dataclasses.asdict(ref)
        shared = {k: ref_fields[k] for k in dataclasses.asdict(mine)}
        assert dataclasses.asdict(mine) == shared
        assert mine._pattern_expanded() == ref._pattern_expanded()
        # the reference's options the port has no field for are all off
        assert (ref.qk_norm, ref.n_experts, ref.frontend, ref.n_prefix_tokens) == (
            False, 0, None, 0)
    assert cfgs[0].cdtype == torch.float32
    assert get_config(ARCH).pdtype == torch.bfloat16


def test_state_dict_keys_are_the_pytree_paths(models):
    model, params = models
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert set(model.state_dict()) == paths
    assert "layers.0.rec.w_in" in paths and "layers.2.attn.wq" in paths
    assert not any(p.requires_grad for p in model.parameters())


def test_rmsnorm_and_rope(cfgs):
    x = _x(1, 2, 9, 4, 16)
    scale = _x(2, 16) + 1.0
    _close(L.rmsnorm(L.RMSNorm(16, torch.float32, torch.device("cpu")), torch.as_tensor(x)),
           JL.rmsnorm({"scale": jnp.ones(16)}, jnp.asarray(x)))
    p = L.RMSNorm(16, torch.float32, torch.device("cpu"))
    p.scale.copy_(torch.as_tensor(scale))
    _close(L.rmsnorm(p, torch.as_tensor(x), 1e-6),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))
    pos = np.arange(100, 109, dtype=np.int32)
    _close(L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def _attn_params(params):
    return params["layers"][2]["attn"]


@pytest.mark.parametrize("T_len,block,window", [
    (16, 512, 64),    # reference: _plain_attention
    (64, 16, 64),     # reference: blockwise_attention (T > 2·block)
    (64, 16, 8),      # blockwise with a narrow band
])
def test_apply_attention_matches_both_reference_branches(models, cfgs, T_len,
                                                         block, window):
    model, params = models
    cfg, jcfg = cfgs
    x = _x(T_len + window, 2, T_len, cfg.d_model, scale=0.5)
    pos = np.arange(T_len, dtype=np.int32)
    size = 48
    out, cache = L.apply_attention(model.layers[2].attn, cfg, torch.as_tensor(x),
                                   torch.as_tensor(pos), window=window,
                                   build_cache=size)
    jout, jcache = JL.apply_attention(_attn_params(params), jcfg, jnp.asarray(x),
                                      jnp.asarray(pos), window=window,
                                      block_size=block, build_cache=size)
    _close(out, jout)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    np.testing.assert_array_equal(_np(cache.positions), _np(jcache.positions))


def test_rolling_cache_decode(models, cfgs):
    """Prefill 40 positions into a 24-slot cache, then decode 30 tokens: the
    slots roll over and the window (16) masks the oldest."""
    model, params = models
    cfg, jcfg = cfgs
    window, size, T0 = 16, 24, 40
    x = _x(7, 1, T0 + 30, cfg.d_model, scale=0.5)
    attn = model.layers[2].attn
    _, cache = L.apply_attention(attn, cfg, torch.as_tensor(x[:, :T0]),
                                 torch.arange(T0, dtype=torch.int32),
                                 window=window, build_cache=size)
    _, jcache = JL.apply_attention(_attn_params(params), jcfg, jnp.asarray(x[:, :T0]),
                                   jnp.arange(T0, dtype=jnp.int32),
                                   window=window, build_cache=size)
    jdecode = jax.jit(lambda p_, x_, pos_, c_: JL.apply_attention(
        p_, jcfg, x_, pos_, cache=c_, window=window))
    for t in range(T0, T0 + 30):
        out, cache = L.apply_attention(attn, cfg, torch.as_tensor(x[:, t:t + 1]),
                                       torch.tensor([t], dtype=torch.int32),
                                       cache=cache, window=window)
        jout, jcache = jdecode(_attn_params(params), jnp.asarray(x[:, t:t + 1]),
                               jnp.asarray([t], dtype=jnp.int32), jcache)
        _close(out, jout)
    _close(cache.k, jcache.k)
    np.testing.assert_array_equal(_np(cache.positions), _np(jcache.positions))


@pytest.mark.parametrize("mode", ["fresh", "continued_prefill", "decode"])
def test_apply_rglru_block(models, cfgs, mode):
    model, params = models
    cfg, jcfg = cfgs
    p, jp = model.layers[0].rec, params["layers"][0]["rec"]
    x = _x(11, 2, 300, cfg.d_model, scale=0.5)
    japply = jax.jit(lambda p_, x_, s_: JRG.apply_rglru_block(p_, jcfg, x_, s_))
    if mode == "fresh":   # 300 > the reference's 256-step chunk
        out, st = RG.apply_rglru_block(p, cfg, torch.as_tensor(x))
        jout, jst = japply(jp, jnp.asarray(x), None)
    else:
        _, st = RG.apply_rglru_block(p, cfg, torch.as_tensor(x[:, :290]))
        _, jst = japply(jp, jnp.asarray(x[:, :290]), None)
        sl = slice(290, 291) if mode == "decode" else slice(290, 300)
        out, st = RG.apply_rglru_block(p, cfg, torch.as_tensor(x[:, sl]), st)
        jout, jst = japply(jp, jnp.asarray(x[:, sl]), jst)
    _close(out, jout)
    _close(st.h, jst.h)
    _close(st.conv, jst.conv)


def test_forward_prefill_and_decode_chain(models, cfgs):
    """Carried weights: full logits, then prefill of 90 tokens (past the
    window of 64) and a chain of 8 decode steps, logits compared at every
    step and the states at the end."""
    model, params = models
    cfg, jcfg = cfgs
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 90))
    logits = T.forward(model, cfg, torch.as_tensor(toks))
    jlogits, _ = jax.jit(lambda p_, t_: JT.forward(p_, jcfg, t_))(
        params, jnp.asarray(toks, dtype=jnp.int32))
    assert logits.shape == (2, 90, cfg.vocab_size)
    _close(logits, jlogits)

    cache_len = 100
    lg, st = T.prefill(model, cfg, torch.as_tensor(toks), cache_len)
    jlg, jst = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, cache_len))(
        params, jnp.asarray(toks, dtype=jnp.int32))
    _close(lg, jlg)
    _close(lg, logits[:, -1])
    jdec = jax.jit(lambda p, tok, s, pos: JT.decode_step(p, jcfg, tok, s, pos))
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(8, 2))
    for i in range(8):
        lg, st = T.decode_step(model, cfg, torch.as_tensor(tok[i]), st, 90 + i)
        jlg, jst = jdec(params, jnp.asarray(tok[i], dtype=jnp.int32), jst,
                        jnp.int32(90 + i))
        _close(lg, jlg)
    for mine, ref in zip(st, jst):
        if isinstance(mine, L.KVCache):
            _close(mine.k, ref.k)
            np.testing.assert_array_equal(_np(mine.positions), _np(ref.positions))
        else:
            _close(mine.h, ref.h)
            _close(mine.conv, ref.conv)


def test_init_decode_state_matches_the_reference(cfgs):
    cfg, jcfg = cfgs
    mine = T.init_decode_state(cfg, 2, 100, device="cpu")
    ref = JT.init_decode_state(jcfg, 2, 100)
    assert len(mine) == len(ref) == 3
    for m, r in zip(mine, ref):
        for name in ("k", "v", "positions") if isinstance(m, L.KVCache) else ("h", "conv"):
            assert tuple(getattr(m, name).shape) == getattr(r, name).shape
            np.testing.assert_array_equal(_np(getattr(m, name)),
                                          _np(getattr(r, name)))


def test_batched_server_tokens_match_the_reference(models, cfgs):
    """Two waves of left-padded prompts, some longer than the window of 64:
    the port's greedy tokens equal the reference server's."""
    model, params = models
    cfg, jcfg = cfgs
    rng = np.random.default_rng(9)
    lens, max_new = [70, 12, 99, 40, 81, 5], [6, 3, 6, 5, 4, 6]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    cache_len = max(lens) + max(max_new)
    mine = [serve.Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))]
    ref = [jax_serve.Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))]
    server = serve.BatchedServer(cfg, model, 4, cache_len)
    server.run(mine)
    jax_serve.BatchedServer(jcfg, params, 4, cache_len).run(ref)
    assert [r.out for r in mine] == [r.out for r in ref]
    assert [len(r.out) for r in mine] == max_new and all(r.done for r in mine)
    assert [(s.batch, s.padded_len, s.decode_steps) for s in server.stats] == \
        [(4, 99, 5), (2, 81, 5)]


def test_cuda_is_the_default_and_never_replaced_by_the_cpu(cfgs):
    """Entry points default to the card; without one they raise unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = cfgs[0]
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_model(cfg, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--demo", "--requests", "1", "--max-new", "1"])
    assert serve.main(["--demo", "--requests", "1", "--max-new", "2",
                       "--device", "cpu"]) == 0
    model = T.init_model(cfg, gen, device="cpu")
    assert model.head.w.device.type == "cpu"


def test_other_families_are_not_ported_yet(cfgs):
    """Every family of the reference is ported now: what is not one of the
    six is refused, as is an arch or an option that neither package has."""
    other = dataclasses.replace(cfgs[0], family="encoder", block_pattern=())
    with pytest.raises(NotImplementedError, match="this runs hybrid, dense"):
        T.init_model(other, None, device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("rwkv7-2.9b")
    for arch in ("rwkv6-1.6b", "musicgen-large", "llava-next-mistral-7b"):
        assert get_config(arch).family in T.FAMILIES
    with pytest.raises(TypeError):
        dataclasses.replace(cfgs[0], n_encoder_layers=2)
