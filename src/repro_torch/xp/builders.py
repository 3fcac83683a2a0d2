"""Model and trainer builders: the paper's 2-NN and one experiment cell.

The port of the reference's ``repro/xp/builders.py``.  ``build_trainer``
assembles the same scheduler, scenario, topology and data as the reference
from the same :class:`~repro_torch.xp.spec.ExperimentSpec`, so both packages
replay the same event stream; the model is the paper's 2-NN (Table 3 shape,
input reduced to the synthetic data's 64 features): 64 → 256 → 256 → 10,
85,002 parameters per worker.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import topology
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.runner import DTYPES, DecentralizedTrainer
from repro_torch.data import ClassificationData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.scenarios import Scenario, get_scenario
from repro_torch.xp.spec import ExperimentSpec


def _logits(params, x):
    # mixed dtypes promote as in the reference (a float32 eval batch against
    # bfloat16 parameters evaluates in float32); equal dtypes cast nothing
    dt = torch.promote_types(x.dtype, params["w1"].dtype)
    p = {k: v.to(dt) for k, v in params.items()}
    h = torch.relu(x.to(dt) @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def mlp2nn_loss(params, batch):
    """Mean cross-entropy of the paper's 2-NN on one batch."""
    logp = torch.log_softmax(_logits(params, batch["x"]), dim=-1)
    return -logp.gather(1, batch["y"].long()[:, None]).mean()


def mlp2nn_eval(params, batch):
    """(loss, accuracy) of the 2-NN on one batch."""
    logits = _logits(params, batch["x"])
    acc = (logits.argmax(-1) == batch["y"].long()).to(torch.float32).mean()
    return mlp2nn_loss(params, batch), acc


def mlp2nn_init(d_in=64, d_h=256, n_cls=10):
    """init(generator) -> the 2-NN's parameters on the CPU (float32):
    N(0, 1/fan_in) weights, zero biases."""
    def init(gen: torch.Generator) -> Dict[str, torch.Tensor]:
        def s(a, b):
            return torch.randn((a, b), generator=gen) / np.sqrt(a)
        return {"w1": s(d_in, d_h), "b1": torch.zeros(d_h),
                "w2": s(d_h, d_h), "b2": torch.zeros(d_h),
                "w3": s(d_h, n_cls), "b3": torch.zeros(n_cls)}
    return init


def params_from_numpy(np_params: Mapping[str, np.ndarray],
                      device: DeviceLike = "cuda",
                      dtype: str = "float32") -> Dict[str, torch.Tensor]:
    """One worker's parameters from NumPy arrays (for example the
    reference's ``mlp2nn_init()(PRNGKey(seed))`` fetched to the host), as the
    port's dict of tensors on ``device``."""
    dev = resolve_device(device)
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
    return {k: torch.tensor(np.asarray(v)).to(device=dev, dtype=DTYPES[dtype])
            for k, v in np_params.items()}


def build_graph(kind: str, n: int, **kw) -> topology.Graph:
    """Topology factory for ExperimentSpec.topology."""
    if kind == "erdos_renyi":
        p = kw.get("p")
        if p is None:
            p = max(0.15, 4.0 / n)
        return topology.erdos_renyi(n, p, seed=kw.get("seed", 1))
    if kind == "ring":
        return topology.ring(n)
    if kind == "fully_connected":
        return topology.fully_connected(n)
    raise KeyError(f"unknown topology {kind!r}; "
                   "have erdos_renyi, ring, fully_connected")


# Per-algorithm scheduler-RNG seed bases (the reference's, so a cell at
# seed s replays the reference's stream at seed s)
_SCHED_SEED_BASE = {"ad_psgd": 1, "prague": 2, "agp": 3}


def build_scenario(spec: ExperimentSpec, name: str, n: int,
                   seed: int) -> Scenario:
    kw = dict(spec.scenario_kw.get(name, {}))
    kw.pop("n", None)
    seed = kw.pop("seed", seed)
    return get_scenario(name, n=n, seed=seed, **kw)


Params = Mapping[str, torch.Tensor]


def build_trainer(spec: ExperimentSpec, alg: str, n: int, seed: int,
                  scenario: Optional[Scenario] = None,
                  dtype: Optional[str] = None,
                  batch_pool: Optional[int] = None,
                  device: DeviceLike = "cuda",
                  init_params: Optional[Union[Params, Sequence[Params]]] = None
                  ) -> DecentralizedTrainer:
    """One (algorithm × topology × scenario × scale × seed) trainer.

    ``init_params`` replaces the torch-native init: one worker's parameters
    (e.g. from :func:`params_from_numpy`), which the trainer stacks over the
    n workers, or a sequence of n, one per worker (``same_init=False``,
    the reference's per-worker keys carried across).
    """
    if scenario is None:
        scenario = build_scenario(spec, spec.scenarios[0], n, seed)
    same_init = True
    if init_params is None:
        init_fn = mlp2nn_init()
    elif isinstance(init_params, Mapping):
        fixed = dict(init_params)
        init_fn = lambda gen: fixed  # noqa: E731
    else:
        if len(init_params) != n:
            raise ValueError(f"init_params holds {len(init_params)} workers' "
                             f"parameters for n={n}")
        per_worker = iter(init_params)
        init_fn = lambda gen: dict(next(per_worker))  # noqa: E731
        same_init = False
    data = ClassificationData(
        n_workers=n, d=64, partition=spec.partition,
        samples_per_worker=256, seed=spec.data_seed)
    g = build_graph(spec.topology, n, **dict(spec.topology_kw))
    sched_kw = {}
    if alg in _SCHED_SEED_BASE:
        sched_kw["seed"] = _SCHED_SEED_BASE[alg] + 7919 * seed
    if alg == "prague":
        sched_kw["group_size"] = spec.group_size
    if alg in ("ad_psgd", "agp") and spec.horizon:
        sched_kw["horizon"] = spec.horizon
    sched = make_scheduler(alg, g, scenario, **sched_kw)
    return DecentralizedTrainer(
        sched, mlp2nn_loss, init_fn,
        lambda w, s: data.batch(w, s, batch_size=32),
        data.eval_batch(1024), eval_fn=mlp2nn_eval,
        eta0=spec.eta0, eta_decay=spec.eta_decay, seed=seed,
        same_init=same_init, mode=spec.mode, block_size=spec.block_size,
        batch_pool=batch_pool if batch_pool is not None else spec.batch_pool,
        dtype=dtype or spec.dtype, device=device,
        telemetry=spec.telemetry, trace=spec.trace, run_log=spec.run_log)
