"""Worker compute-time models (the paper's straggler protocol, §6 + appendix D).

The paper randomly selects workers as stragglers each iteration with
probability ``p`` ("straggler probability", default 10%); a straggler's local
computation is slowed by a factor ``s`` (ablated 5×–40×, default 10×; 6× in
§6).  We add optional persistent heterogeneity (lognormal base speeds) to
model heterogeneous hardware, and a deterministic seed so every experiment is
reproducible.

This pair is the canonical instance of the scenario layer's protocols
(repro/scenarios/base.py): ``StragglerModel`` satisfies ``TimeModelSpec``
(``n`` + ``base_time`` + ``make_sampler``) and ``TimeSampler`` satisfies
``TimeModel`` (``sample``/``sample_batch``/``sample_horizon``/``sample_all``
+ ``base``).  Schedulers only consume those surfaces, so any registered
scenario — heavy-tailed, bimodal, diurnal, churn — drops in wherever a
``StragglerModel`` was accepted; the ``paper_default`` scenario returns an
actual ``TimeSampler`` and is therefore bit-exact with these streams.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    n: int
    straggler_prob: float = 0.10          # paper default 10%
    slowdown: float = 10.0                # paper default 10× (6× in §6 example)
    base_time: float = 1.0                # mean local-gradient time (virtual seconds)
    heterogeneity: float = 0.0            # lognormal sigma of persistent per-worker speed
    jitter: float = 0.05                  # iid lognormal noise per computation
    seed: int = 0

    def make_sampler(self) -> "TimeSampler":
        return TimeSampler(self)


class TimeSampler:
    """Stateful sampler: ``sample(worker) -> duration`` of one local gradient."""

    #: Duration *factors* (jitter × straggler slowdown) are iid across
    #: workers and draws — per-worker structure lives entirely in ``base``
    #: — so a pre-drawn flat factor stream may be assigned to workers in
    #: any order (the fused on-device generator's gate, core/fused.py).
    iid_horizon = True

    #: rng-order sampler surface (repro.check): duration draws happen in
    #: these methods only; ``__init__`` pins the heterogeneity draw.
    rng_methods = ("sample", "sample_batch", "sample_horizon")

    def __init__(self, model: StragglerModel):
        self.model = model
        self._rng = np.random.default_rng(model.seed)
        if model.heterogeneity > 0:
            self.base = model.base_time * self._rng.lognormal(
                mean=0.0, sigma=model.heterogeneity, size=model.n)
        else:
            self.base = np.full(model.n, model.base_time)

    def sample(self, worker: int) -> float:
        m = self.model
        t = self.base[worker]
        if m.jitter > 0:
            t *= self._rng.lognormal(mean=0.0, sigma=m.jitter)
        if self._rng.random() < m.straggler_prob:
            t *= m.slowdown
        return float(t)

    def sample_batch(self, workers) -> np.ndarray:
        """Vectorized draw: one RNG call per distribution for many workers.

        Schedulers restart whole worker sets per event (all of them at t=0);
        drawing their next completion times one `sample()` at a time is the
        event-*generation* hot loop at paper scale.  A single lognormal and a
        single uniform vector draw replace 2·m scalar RNG calls.  For m == 1
        this consumes the generator stream exactly like `sample()` (same
        draw order), so single-restart schedulers keep their streams.
        """
        m = self.model
        workers = np.asarray(workers, dtype=np.intp)
        t = self.base[workers].astype(np.float64, copy=True)
        if m.jitter > 0:
            t *= self._rng.lognormal(mean=0.0, sigma=m.jitter,
                                     size=workers.shape)
        t = np.where(self._rng.random(workers.shape) < m.straggler_prob,
                     t * m.slowdown, t)
        return t

    def sample_horizon(self, k: int) -> np.ndarray:
        """K future duration *factors* drawn at once (event-horizon batching).

        Returns (k,) multiplicative factors — jitter × straggler slowdown —
        to be applied to per-worker base times as completions are assigned:
        ``duration_j = base[worker_j] * factors[j]``.  The distribution of
        each factor is identical to one ``sample()`` draw, but the generator
        stream is consumed as one lognormal(k) then one uniform(k) vector
        call instead of k interleaved scalar pairs, so the resulting event
        stream is a *different* (equally valid, fully deterministic)
        realization than the per-event one — see the ``horizon`` option on
        the single-edge schedulers in core/baselines.py for the trade-off.
        """
        m = self.model
        if m.jitter > 0:
            f = self._rng.lognormal(mean=0.0, sigma=m.jitter, size=k)
        else:
            f = np.ones(k)
        return np.where(self._rng.random(k) < m.straggler_prob,
                        f * m.slowdown, f)

    def sample_all(self) -> np.ndarray:
        return self.sample_batch(np.arange(self.model.n))
