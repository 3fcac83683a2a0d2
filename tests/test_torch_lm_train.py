"""Decentralized LM training in the port against the JAX package, on the CPU.

The data first: ``TokenStream`` and ``CharLMData`` must draw the reference's
tokens bit for bit.  Then the port's ``DecentralizedTrainer`` with the
port's ``lm_loss`` against the reference's trainer with the reference's
``lm_loss``, both from one W0 (the reference's ``init_model`` draw carried
with ``lm_flat_params_from_numpy``), on two reduced LMs: the paper's
char-LM on ``CharLMData`` (``tests/test_system.py``'s set-up) and the
LM example's ``tiny`` qwen3 preset on ``TokenStream``.  At N = 8: DSGD-AAU in
``scan`` and ``sparse_scan`` (one event a row), sync DSGD, and AD-PSGD in
``fused``.  Worker state and losses agree within 1e-4 (float32 sums in
another order over eight events); events, copies and virtual times
exactly, since they come from the shared stream.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import topology as jax_topology
from repro.core.baselines import make_scheduler as jax_make_scheduler
from repro.core.runner import DecentralizedTrainer as JaxTrainer
from repro.core.straggler import StragglerModel as JaxStragglerModel
from repro.data import CharLMData as JaxCharLMData
from repro.data import TokenStream as JaxTokenStream
from repro.data import TokenStreamConfig as JaxTokenStreamConfig
from repro.models import init_model as jax_init_model
from repro.models import lm_loss as jax_lm_loss
from repro_torch.configs import get_config
from repro_torch.core import topology
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.runner import DecentralizedTrainer
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import CharLMData, TokenStream, TokenStreamConfig
from repro_torch.examples import decentralized_lm
from repro_torch.models import lm_flat_params_from_numpy, lm_loss

N = 8
EVENTS = 8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small runs gain nothing from more, and
    the test runner's parallel workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_token_stream_is_bit_identical():
    kw = dict(vocab_size=512, seq_len=16, global_batch=12, n_workers=3, seed=5)
    mine, ref = TokenStream(TokenStreamConfig(**kw)), JaxTokenStream(
        JaxTokenStreamConfig(**kw))
    for w, step in ((0, None), (2, None), (2, 7), (1, None), (0, None)):
        a, b = mine.worker_batch(w, step)["tokens"], ref.worker_batch(w, step)["tokens"]
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(mine.state_dict()["cursor"],
                                  ref.state_dict()["cursor"])
    np.testing.assert_array_equal(mine.global_batch(3)["tokens"],
                                  np.asarray(ref.global_batch(3)["tokens"]))
    np.testing.assert_array_equal(next(iter(mine))["tokens"],
                                  np.asarray(next(iter(ref))["tokens"]))


def test_char_lm_data_is_bit_identical():
    mine = CharLMData(n_workers=4, vocab=80, seq_len=24, seed=3)
    ref = JaxCharLMData(n_workers=4, vocab=80, seq_len=24, seed=3)
    for w, step in ((0, 0), (3, 5), (1, 2)):
        a = mine.batch(w, step, batch_size=5)["tokens"]
        assert a.dtype == np.int32 and a.shape == (5, 24)
        np.testing.assert_array_equal(a, np.asarray(ref.batch(w, step, batch_size=5)["tokens"]))
    np.testing.assert_array_equal(mine.eval_batch(6)["tokens"],
                                  np.asarray(ref.eval_batch(6)["tokens"]))


def _char_lm():
    """``tests/test_system.py``'s set-up: reduced paper-char-lm on
    CharLMData, 20 % stragglers slowed 6×, batches of 8 × 32 tokens."""
    data = {pkg: cls(n_workers=N, vocab=80, seq_len=32, seed=0)
            for pkg, cls in (("port", CharLMData), ("ref", JaxCharLMData))}
    return dict(arch=("paper-char-lm", None), straggler=(0.2, 6.0),
                eta=(0.5, 0.99),
                batch={k: (lambda d: lambda w, s: d.batch(w, s, batch_size=8))(d)
                       for k, d in data.items()},
                eval={k: d.eval_batch(16) for k, d in data.items()})


def _tiny():
    """The LM example's ``tiny`` preset on TokenStream, 10 % stragglers slowed
    10×, batches of 4 × 32 tokens."""
    kw = dict(vocab_size=512, seq_len=32, global_batch=4 * N, n_workers=N)
    streams = {"port": TokenStream(TokenStreamConfig(**kw)),
               "ref": JaxTokenStream(JaxTokenStreamConfig(**kw))}
    return dict(arch=("qwen3-8b", decentralized_lm.PRESETS["tiny"]),
                straggler=(0.1, 10.0), eta=(0.3, 0.999),
                batch={k: s.worker_batch for k, s in streams.items()},
                eval={k: s.worker_batch(0, 10**9) for k, s in streams.items()})


def _configs(arch, preset):
    mine, ref = get_config(arch), jax_get_config(arch)
    if preset is None:
        return mine.reduced(), ref.reduced()
    return tuple(dataclasses.replace(c, name="qwen3-tiny", param_dtype="float32",
                                     compute_dtype="float32", **preset)
                 for c in (mine, ref))


def _run_both(setup, alg, mode):
    cfg, jcfg = _configs(*setup["arch"])
    prob, slow = setup["straggler"]
    eta0, decay = setup["eta"]
    kw = dict(eta0=eta0, eta_decay=decay, seed=0, mode=mode, batch_pool=EVENTS,
              events_per_step=1)
    ref = JaxTrainer(
        jax_make_scheduler(alg, jax_topology.erdos_renyi(N, 0.4, seed=1),
                           JaxStragglerModel(n=N, straggler_prob=prob,
                                             slowdown=slow)),
        lambda p, b: jax_lm_loss(p, jcfg, b),
        lambda k: jax_init_model(k, jcfg), setup["batch"]["ref"],
        setup["eval"]["ref"], **kw)
    w0 = jax.tree.map(np.asarray, jax.device_get(
        jax_init_model(jax.random.PRNGKey(0), jcfg)))
    flat = lm_flat_params_from_numpy(w0, cfg, "cpu")
    port = DecentralizedTrainer(
        make_scheduler(alg, topology.erdos_renyi(N, 0.4, seed=1),
                       StragglerModel(n=N, straggler_prob=prob, slowdown=slow)),
        lambda p, b: lm_loss(p, cfg, b), lambda gen: flat,
        setup["batch"]["port"], setup["eval"]["port"], device="cpu", **kw)
    assert port.mode == ref.mode
    return (ref, ref.run(max_events=EVENTS, eval_every=4),
            port, port.run(max_events=EVENTS, eval_every=4))


@pytest.mark.parametrize("setup", [_char_lm, _tiny], ids=["char_lm", "tiny"])
@pytest.mark.parametrize("alg,mode", [("dsgd_aau", "scan"),
                                      ("dsgd_aau", "sparse_scan"),
                                      ("dsgd_sync", "auto"),
                                      ("ad_psgd", "fused")])
def test_trainer_matches_the_reference(setup, alg, mode):
    ref, res_ref, port, res = _run_both(setup(), alg, mode)
    assert port.mode == (mode if mode != "auto" else "scan")
    assert (res.total_events, res.total_time, res.total_comm_copies,
            res.param_count) == (res_ref.total_events, res_ref.total_time,
                                 res_ref.total_comm_copies, res_ref.param_count)
    assert res.total_events == EVENTS
    assert len(res.history) == len(res_ref.history)
    for a, b in zip(res_ref.history, res.history):
        assert (b.k, b.time, b.comm_param_copies) == (a.k, a.time,
                                                      a.comm_param_copies)
        assert b.n_active_mean == pytest.approx(a.n_active_mean)
        assert b.loss == pytest.approx(a.loss, abs=1e-4)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  jax.device_get(ref.W))}
    assert set(port.W) == set(leaves)
    for k, leaf in leaves.items():
        np.testing.assert_allclose(port.W[k].numpy(), np.asarray(leaf),
                                   atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(port.y.numpy(), np.asarray(jax.device_get(ref.y)),
                               atol=1e-5)
    np.testing.assert_array_equal(port._ptr.numpy(),
                                  np.asarray(jax.device_get(ref._ptr)))


def test_example_runs_and_its_loss_falls(capsys):
    assert decentralized_lm.main(["--preset", "tiny", "--device", "cpu",
                                  "--events", "12", "--seq", "32",
                                  "--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert "model: qwen3-tiny  params=0.7M  workers=8  alg=dsgd_aau" in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("  iter")]
    assert len(losses) >= 2 and losses[-1] < losses[0]
    assert "done: 12 events" in out
