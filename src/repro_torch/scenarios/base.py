"""Scenario layer: the TimeModel protocol and the scenario registry.

The schedulers (core/scheduler.py, core/baselines.py) simulate worker
timelines through a *sampler* object they obtain from whatever was passed as
their ``straggler`` argument.  Historically that argument was always a
:class:`repro.core.straggler.StragglerModel` and the sampler always a
:class:`~repro.core.straggler.TimeSampler`; this module generalizes the pair
into two small protocols so heterogeneity regimes beyond the paper's
iid-Bernoulli straggler protocol (heavy-tailed service times, hardware
clusters, diurnal straggling, worker churn — see scenarios/library.py) plug
into every scheduler unchanged:

- :class:`TimeModel` is the *sampler* contract: ``sample`` /
  ``sample_batch`` / ``sample_horizon`` / ``sample_all`` plus the per-worker
  ``base``-time array.  These are exactly the methods the sparse-native
  generators and the opt-in ``horizon=K`` batcher already call on
  ``TimeSampler``, so any conforming object drops into the scheduler hot
  loops with zero changes there.
- :class:`TimeModelSpec` is the *factory* contract (``n`` +
  ``make_sampler()``) that ``Scheduler.__init__`` consumes.  Both
  ``StragglerModel`` and every :class:`Scenario` satisfy it.

Stream-compatibility contract (pinned by tests/test_scenarios.py): for every
scenario, driving a fresh sampler through repeated ``sample(w)`` calls and
driving another fresh sampler through the equivalent ``sample_batch([w])``
calls must consume the RNG stream identically — the same guarantee
``TimeSampler`` documents for its m == 1 case, which is what lets schedulers
mix the two call styles without forking realizations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Type

import numpy as np

from typing import Protocol, runtime_checkable


@runtime_checkable
class TimeModel(Protocol):
    """Sampler contract every scheduler consumes (duck-typed at runtime).

    ``base`` is the (n,) per-worker base-time array: the horizon batcher
    multiplies its pre-drawn factors by ``base[worker]``, and the runner
    sizes ``max_time``-bounded batch pools from ``base.min()``.
    """

    base: np.ndarray

    def sample(self, worker: int) -> float:
        """Duration of one local gradient computation of ``worker``."""
        ...

    def sample_batch(self, workers) -> np.ndarray:
        """Vectorized draw for a worker index array (restart batches)."""
        ...

    def sample_horizon(self, k: int) -> np.ndarray:
        """K future duration *factors* (multiply ``base[worker]``) at once."""
        ...

    def sample_all(self) -> np.ndarray:
        """One draw for every worker (sync barriers, heap initialization)."""
        ...


@runtime_checkable
class TimeModelSpec(Protocol):
    """Factory contract ``Scheduler.__init__`` accepts.

    ``base_time`` is the mean local-computation scale in virtual seconds —
    AD-PSGD sizes its atomic-averaging lock hold (``avg_time``) relative to
    it, so every spec carries one.
    """

    n: int
    base_time: float

    def make_sampler(self) -> TimeModel:
        ...


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, parameterized compute-time regime (a ``TimeModelSpec``).

    Subclasses add their distribution parameters as dataclass fields, set a
    ``name`` ClassVar, and implement :meth:`make_sampler`.  Scenarios are
    frozen so an experiment record (``ExperimentSpec`` / the bench artifact)
    can embed ``describe()`` and fully determine the realized streams.
    """

    n: int
    seed: int = 0
    base_time: float = 1.0

    name: ClassVar[str] = "base"

    def make_sampler(self) -> TimeModel:
        raise NotImplementedError

    def mean_duration_factor(self) -> float:
        """Analytic E[duration] / base_time — the virtual-clock stretch.

        The experiment harness scales virtual-time budgets by this factor so
        a heavy-tailed scenario gets the same *effective* number of local
        computations as the paper-default one; the distribution sanity tests
        pin the empirical mean against it.
        """
        return 1.0

    def describe(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["scenario"] = self.name
        d["mean_duration_factor"] = self.mean_duration_factor()
        return d


class FactorSampler:
    """Shared TimeModel machinery: ``duration = base[worker] · factor``.

    Subclasses implement the factor draw.  Two hooks cover the two scenario
    shapes:

    - iid scenarios (factors independent of worker identity and history)
      implement :meth:`_factors_iid`; the default :meth:`_factors_for`
      forwards to it, and :meth:`sample_horizon` reuses it directly, so the
      horizon stream is distributionally identical to the per-event one.
    - worker/history-dependent scenarios (e.g. diurnal phases) override
      :meth:`_factors_for` (and usually :meth:`sample_horizon`, since the
      horizon batcher assigns factors to workers only after drawing them —
      the same different-realization caveat the batcher already documents).

    ``sample`` delegates to ``sample_batch`` of a singleton, which *is* the
    stream-compatibility contract of scenarios/base.py — the two call styles
    cannot diverge by construction.
    """

    #: rng-order sampler surface (repro.check): the factor hooks are the
    #: only draw sites; scenario subclasses shadow this when they override
    #: other methods with draws (e.g. a history-dependent sample_horizon).
    rng_methods = ("_factors_iid", "_factors_for")

    def __init__(self, scenario: Scenario, base: np.ndarray):
        self.scenario = scenario
        self.n = scenario.n
        self.base = np.asarray(base, dtype=np.float64)
        self._rng = np.random.default_rng(scenario.seed)

    # -- hooks -------------------------------------------------------------
    def _factors_iid(self, k: int) -> np.ndarray:
        raise NotImplementedError

    def _factors_for(self, workers: np.ndarray) -> np.ndarray:
        return self._factors_iid(len(workers))

    @property
    def iid_horizon(self) -> bool:
        """Whether factor draws are exchangeable across workers and events.

        True exactly when the subclass kept the default ``_factors_for`` /
        ``sample_horizon`` (pure ``_factors_iid`` scenarios): a pre-drawn
        flat factor stream can then be assigned to workers in any order
        without changing the process law — the gate for the fused on-device
        generator (core/fused.py).  Worker/history-dependent overrides
        (diurnal) report False and keep the host paths.
        """
        return (type(self)._factors_for is FactorSampler._factors_for
                and type(self).sample_horizon is FactorSampler.sample_horizon)

    # -- TimeModel ---------------------------------------------------------
    def sample_batch(self, workers) -> np.ndarray:
        workers = np.asarray(workers, dtype=np.intp)
        return self.base[workers] * self._factors_for(workers)

    def sample(self, worker: int) -> float:
        return float(self.sample_batch(np.array([worker], dtype=np.intp))[0])

    def sample_horizon(self, k: int) -> np.ndarray:
        return self._factors_iid(k)

    def sample_all(self) -> np.ndarray:
        return self.sample_batch(np.arange(self.n, dtype=np.intp))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Type[Scenario]] = {}


def register_scenario(cls: Type[Scenario]) -> Type[Scenario]:
    """Class decorator: add a Scenario subclass to the named registry."""
    name = cls.name
    if name in SCENARIOS and SCENARIOS[name] is not cls:
        raise ValueError(f"scenario {name!r} already registered")
    SCENARIOS[name] = cls
    return cls


def scenario_names() -> tuple:
    return tuple(sorted(SCENARIOS))


def get_scenario(name: str, n: int, seed: int = 0, **overrides) -> Scenario:
    """Instantiate a registered scenario at worker count ``n``.

    ``overrides`` set distribution parameters (dataclass fields) of the
    chosen scenario; unknown names raise, so experiment specs can't silently
    typo a knob.
    """
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {list(scenario_names())}")
    cls = SCENARIOS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    bad = set(overrides) - fields
    if bad:
        raise TypeError(
            f"scenario {name!r} has no parameter(s) {sorted(bad)}; "
            f"available: {sorted(fields - {'n', 'seed'})}")
    return cls(n=n, seed=seed, **overrides)
