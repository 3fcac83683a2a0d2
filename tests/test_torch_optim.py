"""The port's optimizers and learning-rate schedules against the JAX
package's (``repro.optim``), on the CPU.

Each optimizer runs five steps on one set of NumPy parameters and
gradients in both packages; after every step the updates, the optimizer
state and the parameters must agree (float32 atol 2e-5 / rtol 1e-4; AdamW
on bf16 parameters, whose float32 moments are held at the float32
tolerance and whose bf16 parameters at 2e-2).  Each schedule is held over
steps 0-50.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim
from repro_torch.core.runner import DecentralizedTrainer

TOL = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
SHAPES = {"embed.table": (6, 4), "layers.attn.wq": (2, 4, 3), "head.b": (5,)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_key(k):
    return k.replace(".", "/")


def _draw(seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("name,kw,dtype", [
    ("sgd", {}, "float32"),
    ("momentum", {"beta": 0.9}, "float32"),
    ("momentum", {"beta": 0.8, "nesterov": True}, "float32"),
    ("adamw", {"weight_decay": 0.1}, "bfloat16"),
    ("adamw", {"b1": 0.8, "b2": 0.99, "eps": 1e-6}, "float32"),
])
def test_optimizer_matches_the_reference_over_five_steps(name, kw, dtype):
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    p0 = _draw(0, dtype)
    params = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    jparams = {_jax_key(k): jnp.asarray(v, jdt) for k, v in p0.items()}
    opt, jopt = optim.make(name, **kw), jax_optim.make(name, **kw)
    state, jstate = opt.init(params), jopt.init(jparams)
    ptol = BF16 if dtype == "bfloat16" else TOL
    for step in range(5):
        g = _draw(10 + step, dtype)
        grads = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        jgrads = {_jax_key(k): jnp.asarray(v, jdt) for k, v in g.items()}
        upd, state = opt.update(grads, state, params, 0.05)
        jupd, jstate = jopt.update(jgrads, jstate, jparams, 0.05)
        params = optim.apply_updates(params, upd)
        jparams = jax_optim.apply_updates(jparams, jupd)
        for k in SHAPES:
            np.testing.assert_allclose(_np(upd[k]), _np(jupd[_jax_key(k)]),
                                       **ptol)
            np.testing.assert_allclose(_np(params[k]),
                                       _np(jparams[_jax_key(k)]), **ptol)
            assert params[k].dtype == tdt
        if name == "momentum":
            for k in SHAPES:
                np.testing.assert_allclose(_np(state[k]),
                                           _np(jstate[_jax_key(k)]), **TOL)
        if name == "adamw":
            assert state.count.dtype == torch.int32
            assert int(state.count) == int(jstate.count) == step + 1
            for k in SHAPES:
                assert state.mu[k].dtype == state.nu[k].dtype == torch.float32
                np.testing.assert_allclose(_np(state.mu[k]),
                                           _np(jstate.mu[_jax_key(k)]), **TOL)
                np.testing.assert_allclose(_np(state.nu[k]),
                                           _np(jstate.nu[_jax_key(k)]), **TOL)
    assert set(optim.REGISTRY) == set(jax_optim.optimizers.REGISTRY)


SCHEDULES = [
    ("constant", (0.1,), {}),
    ("exponential", (0.1,), {"delta": 0.95, "decay_every": 3}),
    ("cosine", (0.1, 50), {"warmup": 5, "eta_min": 0.01}),
    ("cosine", (0.2, 40), {}),
    ("wsd", (0.1, 50), {}),
    ("wsd", (0.3, 50), {"warmup_frac": 0.1, "decay_frac": 0.3,
                         "eta_min_frac": 0.05}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedule_matches_the_reference(name, args, kw):
    fn = getattr(optim.schedules, name)(*args, **kw)
    jfn = getattr(jax_optim.schedules, name)(*args, **kw)
    for step in range(51):
        out = fn(step)
        assert out.dtype == torch.float32 and out.dim() == 0
        np.testing.assert_allclose(float(out), float(jfn(step)), **TOL)


@pytest.mark.parametrize("every", [1, 3, 7])
def test_exponential_is_the_trainers_eta_decay(every):
    """``exponential(eta0, delta, decay_every)`` is the step size the
    decentralized trainer gives event k (``eta0``, ``eta_decay``,
    ``eta_decay_every``), to float32 rounding."""
    fn = optim.schedules.exponential(0.1, 0.95, decay_every=every)
    trainer = types.SimpleNamespace(eta0=0.1, eta_decay=0.95,
                                    eta_decay_every=every)
    etas = DecentralizedTrainer._etas(trainer, np.arange(51))
    np.testing.assert_allclose([float(fn(k)) for k in range(51)], etas,
                               rtol=1e-6)
