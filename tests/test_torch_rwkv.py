"""The port's ssm family (RWKV6) against the JAX package, on the CPU.

The RWKV functions (``repro_torch.models.rwkv``) run on inputs drawn with
NumPy and on time-mix / channel-mix weights drawn by the reference's
``init_time_mix`` / ``init_channel_mix`` and carried over with
``convert.load_numpy``; the reduced rwkv6-1.6b (2 layers, d 256, 4 heads of
64) runs on weights drawn by the reference's ``init_model`` and carried
over with ``lm_params_from_numpy``.  Tolerances: float32 atol 2e-5 / rtol
1e-4 for the recurrence, the blocks, the losses and the gradients (the
same function summed in another order); 1e-4 for logits; greedy tokens
exactly.

The reference evaluates a ragged T > 64 as a T-step scan (chunks of one
token) and the port as 64-token chunks plus one remainder chunk; the
cases at T = 100 and T = 70 hold the two groupings against each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T

TOL = dict(atol=2e-5, rtol=1e-4)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "rwkv6-1.6b"


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


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tokens(seed, vocab, B, T_len):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T_len)
                                                ).astype(np.int32)


def _cfgs():
    return get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()


def _recurrence_inputs(seed, B=2, H=3, T_len=128, K=16, V=16):
    """r, k, v, w (decays in (0, 1), about the seeded init's 0.87), u, S0."""
    r, k = _x(seed, B, H, T_len, K), _x(seed + 1, B, H, T_len, K)
    v = _x(seed + 2, B, H, T_len, V)
    w = np.exp(-np.exp(_x(seed + 3, B, H, T_len, K, scale=0.3) - 2.0)).astype(np.float32)
    u = _x(seed + 4, H, K, scale=0.05)
    S0 = _x(seed + 5, B, H, K, V, scale=0.5)
    return r, k, v, w, u, S0


_BLOCKS = {}


def _blocks():
    """(TimeMix, ChannelMix, their reference params) on the reduced config,
    the same weights in both; built once."""
    if not _BLOCKS:
        cfg, jcfg = _cfgs()
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        # the seeded decay lora is tiny (scale 0.01): widen it tenfold so
        # that the decay varies with the input (w in ~0.6-0.96), within
        # the regime where the two groupings of a ragged T agree (a
        # 64-token chunk's cumulative decay above 1e-20; checked below)
        tm = dict(JR.init_time_mix(k1, jcfg))
        tm["decay_A"] = tm["decay_A"] * 10
        tm["decay_B"] = tm["decay_B"] * 10
        cm = JR.init_channel_mix(k2, jcfg)
        tm, cm = (jax.tree.map(np.asarray, p) for p in (tm, cm))
        _BLOCKS.update(
            tm=convert.load_numpy(R.TimeMix(cfg, None, torch.device("cpu")), tm),
            cm=convert.load_numpy(R.ChannelMix(cfg, None, torch.device("cpu")), cm),
            jtm=tm, jcm=cm)
    return _BLOCKS


_MODELS = {}


def _model():
    """(port cfg, reference cfg, port model on the CPU, reference params) of
    the reduced rwkv6, the same weights in both; built once."""
    if not _MODELS:
        cfg, jcfg = _cfgs()
        params = JT.init_model(jax.random.PRNGKey(0), jcfg)
        model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                             cfg, "cpu")
        _MODELS["m"] = (cfg, jcfg, model, params)
    return _MODELS["m"]


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_rwkv_matches_the_reference(chunk):
    ins = _recurrence_inputs(1)
    y, S = R.chunked_rwkv(*map(torch.as_tensor, ins), chunk=chunk)
    jy, jS = JR.chunked_rwkv(*map(jnp.asarray, ins), chunk=chunk)
    assert y.shape == (2, 3, 128, 16) and S.shape == (2, 3, 16, 16)
    assert y.dtype == S.dtype == torch.float32
    _close(y, jy)
    _close(S, jS)


def test_chunked_rwkv_refuses_a_chunk_that_does_not_divide_t():
    ins = map(torch.as_tensor, _recurrence_inputs(1, T_len=100))
    with pytest.raises(ValueError, match="does not divide"):
        R.chunked_rwkv(*ins, chunk=64)


def test_rwkv_step_matches_the_reference():
    r, k, v, w, u, S0 = _recurrence_inputs(2, T_len=1)
    one = [a[:, :, 0] for a in (r, k, v, w)]
    y, S = R.rwkv_step(*map(torch.as_tensor, one), torch.as_tensor(u),
                       torch.as_tensor(S0))
    jy, jS = JR.rwkv_step(*map(jnp.asarray, one), jnp.asarray(u), jnp.asarray(S0))
    _close(y, jy)
    _close(S, jS)


def test_steps_and_chunks_compute_one_recurrence():
    """T decode steps from S0 against one chunked pass over the T tokens."""
    r, k, v, w, u, S0 = map(torch.as_tensor, _recurrence_inputs(3, T_len=32))
    y, S = R.chunked_rwkv(r, k, v, w, u, S0, chunk=16)
    St, ys = S0, []
    for t in range(32):
        yt, St = R.rwkv_step(r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t], u, St)
        ys.append(yt)
    _close(y, torch.stack(ys, dim=2))
    _close(S, St)


@pytest.mark.parametrize("T_len", [100, 37, 130])
def test_remainder_grouping_matches_chunks_of_one(T_len):
    """The port's ragged grouping (64-token chunks, then the remainder)
    against the reference's for T > 64 (``chunk=1``), on the reference's
    own ``chunked_rwkv``."""
    ins = _recurrence_inputs(4, T_len=T_len)
    y, S = R._recurrence(*map(torch.as_tensor, ins), chunk=64)
    jy, jS = JR.chunked_rwkv(*map(jnp.asarray, ins), chunk=1)
    _close(y, jy)
    _close(S, jS)


def test_fast_decays_part_the_groupings_where_a_chunk_decay_floors():
    """Where the port's ragged grouping and the reference's part.  Decays
    planted about 0.3 take a 64-token chunk's cumulative decay below the
    1e-20 floor from its 37th token on (0.3^37 ~ 4e-20 at the mean).  Up to
    the first floored token the two agree to float32 rounding; after it the
    port's intra-chunk terms that read a floored A_s are underestimated and
    the outputs part by O(|y|).  The remainder chunk (36 tokens) stays above
    the floor and the error in the state decays away within it, so the
    final states agree."""
    r, k, v, w, u, S0 = _recurrence_inputs(4, T_len=100)
    w = np.exp(-np.exp(_x(14, *w.shape, scale=0.1)
                       + np.log(-np.log(0.3)))).astype(np.float32)
    ins = (r, k, v, w, u, S0)
    y, S = R._recurrence(*map(torch.as_tensor, ins), chunk=64)
    jy, jS = JR.chunked_rwkv(*map(jnp.asarray, ins), chunk=1)
    A = np.cumprod(w[:, :, :64].astype(np.float64), axis=2)
    floored = (A < 1e-20).any(axis=(0, 1, 3))
    first = int(np.argmax(floored))
    assert floored.any() and 30 <= first < 45
    # position t reads A_s for s < t only: exact through t = first
    _close(y[:, :, :first + 1], np.asarray(jy)[:, :, :first + 1])
    gap = float(np.abs(_np(y) - np.asarray(jy))[:, :, first + 1:64].max())
    assert gap > 0.1 * float(np.abs(np.asarray(jy)).max())
    _close(S, jS)


def test_seeded_decay_stays_above_the_chunk_floor():
    """The remainder grouping agrees with the reference's while a chunk's
    cumulative decay stays above the 1e-20 floor; at the seeded init a
    64-token chunk's is about 2e-4."""
    cfg, _ = _cfgs()
    tm = R.TimeMix(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    x = torch.as_tensor(_x(5, 2, 64, cfg.d_model))
    w = R._decay(tm, x)
    A64 = torch.exp(torch.log(w).sum(dim=1))
    assert 1e-5 < float(A64.min()) and float(A64.max()) < 1e-3
    assert abs(float(w.mean()) - float(np.exp(-np.exp(-2.0)))) < 0.01


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def test_token_shift_and_lerp():
    x = _x(6, 2, 5, 8)
    prev = _x(7, 2, 8)
    for carry in (None, prev):
        out = R._token_shift(torch.as_tensor(x),
                             None if carry is None else torch.as_tensor(carry))
        ref = JR._token_shift(jnp.asarray(x),
                              None if carry is None else jnp.asarray(carry))
        np.testing.assert_array_equal(_np(out), _np(ref))
    mu = _x(8, 8)
    _close(R._lerp(torch.as_tensor(mu), torch.as_tensor(x), torch.as_tensor(x[::-1].copy())),
           JR._lerp(jnp.asarray(mu), jnp.asarray(x), jnp.asarray(x[::-1].copy())))


@pytest.mark.parametrize("T_len", [128, 100, 37, 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_time_mix_matches_the_reference(T_len, with_state):
    """T = 128 (chunks of 64 in both), 100 (the reference's chunks of one
    against the port's 64 + 36), 37 (one chunk of T in both) and 1 (the
    decode step), from zeros or from a carried state."""
    cfg, jcfg = _cfgs()
    b = _blocks()
    x = _x(9, 2, T_len, cfg.d_model)
    state = jstate = None
    if with_state:
        H = cfg.d_model // cfg.rwkv_head_dim
        sh, s = _x(10, 2, cfg.d_model), _x(11, 2, H, 64, 64, scale=0.3)
        state = R.RWKVState(torch.as_tensor(sh), torch.zeros(2, cfg.d_model),
                            torch.as_tensor(s))
        jstate = JR.RWKVState(jnp.asarray(sh), jnp.zeros((2, cfg.d_model)),
                              jnp.asarray(s))
    w = R._decay(b["tm"], torch.as_tensor(x))
    assert float(w.min()) < 0.75 and float(w.max()) > 0.9    # data-dependent
    if T_len > 64:   # every 64-token window's decay stays above the floor
        logw = torch.log(w).cumsum(dim=1)
        assert float((logw[:, 64:] - logw[:, :-64]).min()) > np.log(1e-20)
    out, S, last = R.apply_time_mix(b["tm"], cfg, torch.as_tensor(x), state)
    jout, jS, jlast = JR.apply_time_mix(b["jtm"], jcfg, jnp.asarray(x), jstate)
    assert out.shape == (2, T_len, cfg.d_model)
    _close(out, jout)
    _close(S, jS)
    np.testing.assert_array_equal(_np(last), _np(jlast))


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_channel_mix_matches_the_reference(with_state):
    cfg, _ = _cfgs()
    b = _blocks()
    x = _x(12, 2, 9, cfg.d_model)
    prev = _x(13, 2, cfg.d_model) if with_state else None
    out, last = R.apply_channel_mix(b["cm"], torch.as_tensor(x),
                                    None if prev is None else torch.as_tensor(prev))
    jout, jlast = JR.apply_channel_mix(b["jcm"], jnp.asarray(x),
                                       None if prev is None else jnp.asarray(prev))
    _close(out, jout)
    np.testing.assert_array_equal(_np(last), _np(jlast))


def test_blocks_carry_the_reference_leaves():
    """Leaf names and shapes of the reference's init functions; the decay
    lora is max(32, d // 32) wide; the seeded draws at the reference's
    scales."""
    cfg, jcfg = _cfgs()
    tm = R.TimeMix(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    cm = R.ChannelMix(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    for mod, ref in ((tm, JR.init_time_mix(jax.random.PRNGKey(0), jcfg)),
                     (cm, JR.init_channel_mix(jax.random.PRNGKey(0), jcfg))):
        leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
                  for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
        assert {k: tuple(v.shape) for k, v in mod.state_dict().items()} == leaves
    assert tm.decay_A.shape == (256, 32) and tm.bonus_u.shape == (4, 64)
    assert abs(float(tm.bonus_u.std()) - 0.05) < 0.01
    assert abs(float(tm.decay_A.std()) - 0.01) < 0.001
    assert abs(float(tm.w_r.std()) - 256 ** -0.5) < 0.003
    assert float(tm.decay_w0[0]) == -2.0 and float(cm.mu_k[0]) == 0.5
    stacked = R.TimeMix(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                        lead=(3,))
    assert stacked.w_r.shape == (3, 256, 256)
    assert stacked.out_norm.scale.shape == (3, 256)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    for mine, ref in ((get_config(ARCH), jax_get_config(ARCH)), _cfgs()):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.is_attention_free and mine.supports_long_context
        assert mine.with_sliding_window() is mine
    red = get_config(ARCH).reduced()
    assert (red.n_heads, red.d_head, red.rwkv_head_dim) == (0, 0, 64)
    assert red.cdtype == torch.float32


def test_param_count_matches_the_reference_at_full_size():
    """The config's formula is the reference's approximate 12·d² a layer;
    the exact count comes from the shapes, in both packages."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 1_476_495_360
    assert T.param_count(cfg) == JT.param_count(jcfg) == 1_583_941_632


def test_state_dict_is_the_layer_stacked_pytree():
    cfg, _, model, params = _model()
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == leaves
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    assert leaves["layers.time_mix.w_r"] == (L, d, d)
    assert leaves["layers.time_mix.bonus_u"] == (L, 4, 64)
    assert leaves["layers.time_mix.out_norm.scale"] == (L, d)
    assert leaves["layers.channel_mix.w_k"] == (L, d, f)


@pytest.mark.parametrize("T_len", [64, 70, 37])
def test_forward_prefill_and_decode_chain(T_len):
    """Full logits at T = 64, 70 (ragged past one chunk) and 37, then
    prefill and a chain of 6 decode steps, logits compared at every step,
    the decode state too."""
    cfg, jcfg, model, params = _model()
    toks = _tokens(3, cfg.vocab_size, 2, T_len)
    logits = T.forward(model, cfg, torch.as_tensor(toks))
    jlogits, _ = jax.jit(lambda p_, t_: JT.forward(p_, jcfg, t_))(
        params, jnp.asarray(toks))
    _close(logits, jlogits, LOGITS_TOL)

    lg, st = T.prefill(model, cfg, torch.as_tensor(toks), 0)
    jlg, jst = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, 0))(
        params, jnp.asarray(toks))
    _close(lg, jlg, LOGITS_TOL)
    _close(lg, logits[:, -1], LOGITS_TOL)
    jdec = jax.jit(lambda p, tok, s, pos: JT.decode_step(p, jcfg, tok, s, pos))
    nxt = _tokens(4, cfg.vocab_size, 6, 2)
    for i in range(6):
        lg, st = T.decode_step(model, cfg, torch.as_tensor(nxt[i]), st, T_len + i)
        jlg, jst = jdec(params, jnp.asarray(nxt[i]), jst, jnp.int32(T_len + i))
        _close(lg, jlg, LOGITS_TOL)
    _close(torch.stack([s.S for s in st]), jst.S)
    _close(torch.stack([s.shift_tm for s in st]), jst.shift_tm)
    _close(torch.stack([s.shift_cm for s in st]), jst.shift_cm)


def test_decode_state_does_not_grow_with_the_prompt():
    """The prefilled state holds exactly the bytes of the empty one (no
    view of the prompt's activations kept), whatever the prompt length."""
    cfg, _, model, _ = _model()

    def storage_bytes(state):
        return sum(t.untyped_storage().nbytes() for s in state for t in s)

    empty = T.init_decode_state(cfg, 2, 0, device="cpu")
    assert [tuple(t.shape) for t in empty[0]] == [(2, 256), (2, 256), (2, 4, 64, 64)]
    assert empty[0].S.dtype == torch.float32
    for T_len in (5, 130):
        _, st = T.prefill(model, cfg, torch.as_tensor(_tokens(1, 512, 2, T_len)), 0)
        assert storage_bytes(st) == storage_bytes(empty)


@pytest.mark.parametrize("logit_chunk", [None, 7])
def test_lm_loss_matches_the_reference(logit_chunk):
    cfg, jcfg, model, params = _model()
    toks = _tokens(5, cfg.vocab_size, 2, 70)
    ref = jax.jit(lambda p_, t_: JT.lm_loss(p_, jcfg, {"tokens": t_},
                                            logit_chunk=logit_chunk))(
        params, jnp.asarray(toks))
    batch = {"tokens": torch.as_tensor(toks)}
    _close(T.lm_loss(model, cfg, batch, logit_chunk=logit_chunk), ref)
    flat = convert.lm_flat_params_from_numpy(jax.tree.map(np.asarray, params),
                                             cfg, "cpu")
    assert flat["layers.time_mix.decay_A"].shape == (cfg.n_layers, cfg.d_model, 32)
    _close(T.lm_loss(flat, cfg, batch, logit_chunk=logit_chunk), ref)


def test_grad_of_lm_loss_matches_jax_grad():
    """``torch.func.grad`` over the flat dict against ``jax.grad`` of the
    reference, leaf by leaf, at a ragged T = 67 (the reference's chunks of
    one token against the port's 64 + 3)."""
    cfg, jcfg, model, params = _model()
    toks = _tokens(7, cfg.vocab_size, 2, 67)
    jg = jax.jit(jax.grad(lambda p: JT.lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)})))(
        params)
    g = torch.func.grad(lambda p: T.lm_loss(p, cfg, {"tokens": torch.as_tensor(toks)}))(
        T.flat_params(model))
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jg)}
    assert set(g) == set(ref)
    assert float(g["layers.time_mix.decay_A"].abs().max()) > 0
    for k in ref:
        _close(g[k], ref[k])


def test_batched_server_tokens_match_the_reference():
    """Reduced rwkv6 behind both servers: 5 requests of 3-80 tokens in
    2-slot waves, 6 greedy tokens each."""
    cfg, jcfg, model, params = _model()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 80, 17, 66, 9)]
    outs = []
    for mod, weights, c in ((serve, model, cfg), (jax_serve, params, jcfg)):
        reqs = [mod.Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        mod.BatchedServer(c, weights, batch_slots=2, cache_len=96).run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 6 for o in outs[0])


def test_serve_cli_runs_rwkv(capsys):
    assert serve.main(["--arch", ARCH, "--demo", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
