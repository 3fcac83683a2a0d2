"""The registered scenario library.

Five named compute-time regimes (plus whatever downstream code registers):

- ``paper_default`` — the paper's §6 protocol, *bit-exact* with the seed
  repo's ``StragglerModel``/``TimeSampler`` streams: ``make_sampler`` returns
  a real :class:`~repro.core.straggler.TimeSampler`, so every recorded run
  replays unchanged (tests/test_scenarios.py pins all five schedulers).
- ``heavy_tail`` — Pareto service times: the AD-PSGD/Hop line of work
  observes that real clusters show heavy-tailed (not Bernoulli) slowdowns;
  with tail index α ≤ 2 the variance is infinite and "the straggler" is a
  different worker every few hundred events.
- ``bimodal`` — two persistent hardware clusters (fast/slow machines), the
  Hop paper's heterogeneous-cluster regime: a fixed random subset of workers
  is ``slow_factor``× slower *forever*, instead of transiently.
- ``diurnal`` — time-varying stragglers: each worker's straggler probability
  follows a sinusoid in its local-computation count (a deterministic proxy
  for virtual time — draws are exactly the worker's successive computations),
  with phases spread across workers, so the slow set drifts around the
  cluster like a load wave.
- ``churn`` — temporary worker dropout: with small probability a completed
  computation is followed by an offline period (exponential, mean
  ``downtime`` base-times) before the worker re-enters.  Re-entry is
  scheduler-safe by construction: a churned worker is simply a very late
  completion on the event heap — the same path stragglers and isolated
  workers already exercise — so no scheduler ever blocks on it (AD-PSGD's
  averaging lock, in particular, is only held at completion, never across
  the downtime).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np

from repro_torch.core.straggler import StragglerModel, TimeSampler
from repro_torch.scenarios.base import (FactorSampler, Scenario, TimeModel,
                                  register_scenario)


@register_scenario
@dataclasses.dataclass(frozen=True)
class PaperDefaultScenario(Scenario):
    """The paper's straggler protocol (§6 + appendix D), unchanged.

    A thin factory over :class:`StragglerModel`: the sampler *is* a
    ``TimeSampler`` seeded identically, so the event streams of every
    scheduler are bit-exact with the pre-scenario-engine repo state.
    """

    straggler_prob: float = 0.10
    slowdown: float = 10.0
    heterogeneity: float = 0.0
    jitter: float = 0.05

    name: ClassVar[str] = "paper_default"

    def make_sampler(self) -> TimeModel:
        return TimeSampler(StragglerModel(
            n=self.n, straggler_prob=self.straggler_prob,
            slowdown=self.slowdown, base_time=self.base_time,
            heterogeneity=self.heterogeneity, jitter=self.jitter,
            seed=self.seed))

    def mean_duration_factor(self) -> float:
        mix = 1.0 + self.straggler_prob * (self.slowdown - 1.0)
        return (mix * math.exp(self.jitter ** 2 / 2)
                * math.exp(self.heterogeneity ** 2 / 2))


class _HeavyTailSampler(FactorSampler):
    rng_methods = ("_factors_iid",)

    def _factors_iid(self, k: int) -> np.ndarray:
        # Pareto with x_m = 1: the fastest computation is the base time, the
        # tail P[factor > x] = x^{-α} produces occasional enormous stragglers.
        return 1.0 + self._rng.pareto(self.scenario.alpha, size=k)


@register_scenario
@dataclasses.dataclass(frozen=True)
class HeavyTailScenario(Scenario):
    """Pareto(α) service times, x_m = base_time; α ≤ 2 ⇒ infinite variance."""

    alpha: float = 1.5

    name: ClassVar[str] = "heavy_tail"

    def make_sampler(self) -> TimeModel:
        return _HeavyTailSampler(self, np.full(self.n, self.base_time))

    def mean_duration_factor(self) -> float:
        a = self.alpha
        # E[1 + Lomax(α)] = α/(α−1); below α ≈ 1 the mean diverges — return a
        # finite surrogate so budget scaling stays usable.
        return a / (a - 1.0) if a > 1.05 else 20.0


class _BimodalSampler(FactorSampler):
    rng_methods = ("_factors_iid",)

    def __init__(self, scenario: "BimodalScenario"):
        n = scenario.n
        rng = np.random.default_rng(scenario.seed)
        n_slow = int(round(scenario.slow_frac * n))
        slow = rng.choice(n, size=n_slow, replace=False)
        base = np.full(n, scenario.base_time)
        base[slow] *= scenario.slow_factor
        super().__init__(scenario, base)
        # the cluster split consumed draws from a separate construction-time
        # stream; per-draw factors start from the scenario seed offset by one
        # so the split and the jitter streams never alias
        self._rng = np.random.default_rng(scenario.seed + 1)
        self.slow_workers = np.sort(slow)

    def _factors_iid(self, k: int) -> np.ndarray:
        j = self.scenario.jitter
        if j <= 0:
            return np.ones(k)
        return self._rng.lognormal(mean=0.0, sigma=j, size=k)


@register_scenario
@dataclasses.dataclass(frozen=True)
class BimodalScenario(Scenario):
    """Two persistent hardware clusters: slow_frac of workers slow_factor× slower."""

    slow_frac: float = 0.25
    slow_factor: float = 5.0
    jitter: float = 0.05

    name: ClassVar[str] = "bimodal"

    def make_sampler(self) -> TimeModel:
        return _BimodalSampler(self)

    def mean_duration_factor(self) -> float:
        frac = round(self.slow_frac * self.n) / max(self.n, 1)
        return ((1.0 + frac * (self.slow_factor - 1.0))
                * math.exp(self.jitter ** 2 / 2))


class _DiurnalSampler(FactorSampler):
    # phase-dependent draws live in the worker-aware hook and the horizon
    # override, not _factors_iid (there is no iid law to forward to)
    rng_methods = ("_factors_for", "sample_horizon")

    def __init__(self, scenario: "DiurnalScenario"):
        super().__init__(scenario, np.full(scenario.n, scenario.base_time))
        # phase offsets spread deterministically across the ring of workers:
        # the straggling "load wave" travels through the cluster
        self._phase = np.arange(scenario.n) / max(scenario.n, 1)
        self._count = np.zeros(scenario.n, dtype=np.int64)
        self._gcount = 0

    def _prob_at(self, cycles: np.ndarray) -> np.ndarray:
        p = self.scenario.straggler_prob
        return p * 0.5 * (1.0 + np.sin(2.0 * np.pi * cycles))

    def _factors_for(self, workers: np.ndarray) -> np.ndarray:
        sc = self.scenario
        f = (self._rng.lognormal(mean=0.0, sigma=sc.jitter, size=len(workers))
             if sc.jitter > 0 else np.ones(len(workers)))
        cycles = (self._count[workers] / sc.period) + self._phase[workers]
        p = self._prob_at(cycles)
        f = np.where(self._rng.random(len(workers)) < p, f * sc.slowdown, f)
        np.add.at(self._count, workers, 1)
        return f

    def sample_horizon(self, k: int) -> np.ndarray:
        # The horizon batcher assigns factors to workers only *after* the
        # draw, so per-worker phases are unknowable here; a global draw
        # counter stands in for the phase.  Like the batcher itself this is
        # a different-but-deterministic realization of the same marginal
        # straggler intensity.
        sc = self.scenario
        f = (self._rng.lognormal(mean=0.0, sigma=sc.jitter, size=k)
             if sc.jitter > 0 else np.ones(k))
        cycles = (self._gcount + np.arange(k)) / sc.period
        p = self._prob_at(cycles)
        f = np.where(self._rng.random(k) < p, f * sc.slowdown, f)
        self._gcount += k
        return f


@register_scenario
@dataclasses.dataclass(frozen=True)
class DiurnalScenario(Scenario):
    """Time-varying stragglers: sinusoidal straggler intensity per worker.

    Worker w's s-th local computation straggles with probability
    ``straggler_prob · ½(1 + sin 2π(s/period + w/n))`` — peak intensity
    ``straggler_prob``, trough 0, phase-shifted around the cluster.  The
    draw counter s is the per-worker virtual-time proxy: draws are exactly
    the worker's successive computations, so one ``period`` spans about
    ``period · base_time · mean_factor`` virtual seconds.
    """

    straggler_prob: float = 0.3
    slowdown: float = 10.0
    period: float = 64.0
    jitter: float = 0.05

    name: ClassVar[str] = "diurnal"

    def make_sampler(self) -> TimeModel:
        return _DiurnalSampler(self)

    def mean_duration_factor(self) -> float:
        # phase-averaged straggler probability is straggler_prob / 2
        return ((1.0 + 0.5 * self.straggler_prob * (self.slowdown - 1.0))
                * math.exp(self.jitter ** 2 / 2))


class _ChurnSampler(FactorSampler):
    rng_methods = ("_factors_iid",)

    def _factors_iid(self, k: int) -> np.ndarray:
        sc = self.scenario
        f = (self._rng.lognormal(mean=0.0, sigma=sc.jitter, size=k)
             if sc.jitter > 0 else np.ones(k))
        # the downtime vector is drawn unconditionally so scalar and batched
        # call styles consume the stream identically (the base contract)
        down = self._rng.random(k) < sc.churn_prob
        off = self._rng.exponential(sc.downtime, size=k)
        return f + np.where(down, off, 0.0)


@register_scenario
@dataclasses.dataclass(frozen=True)
class ChurnScenario(Scenario):
    """Temporary worker dropout: rare exponential offline periods.

    With probability ``churn_prob`` a worker's completed computation is
    followed by an offline period of mean ``downtime`` base-times before it
    rejoins.  Because the downtime is folded into the completion interval,
    re-entry rides the existing late-completion paths: asynchronous
    schedulers keep making progress without the worker (exactly like a
    straggler), and on its return DSGD-AAU's Pathsearch folds its
    information back into the spanning structure.
    """

    churn_prob: float = 0.02
    downtime: float = 25.0
    jitter: float = 0.05

    name: ClassVar[str] = "churn"

    def make_sampler(self) -> TimeModel:
        return _ChurnSampler(self, np.full(self.n, self.base_time))

    def mean_duration_factor(self) -> float:
        return (math.exp(self.jitter ** 2 / 2)
                + self.churn_prob * self.downtime)
