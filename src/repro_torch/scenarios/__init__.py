"""Scenario subsystem: named worker compute-time regimes.

``get_scenario("heavy_tail", n=256)`` returns a frozen
:class:`~repro.scenarios.base.Scenario` that any scheduler accepts wherever
it previously took a :class:`~repro.core.straggler.StragglerModel` (both
satisfy the :class:`~repro.scenarios.base.TimeModelSpec` protocol).  The
``paper_default`` scenario is bit-exact with the historical
``StragglerModel`` streams; the rest open the heterogeneity regimes the
related straggler literature studies (see scenarios/library.py).
"""
from repro_torch.scenarios.base import (FactorSampler, Scenario, TimeModel,
                                  TimeModelSpec, get_scenario,
                                  register_scenario, scenario_names)
from repro_torch.scenarios.library import (BimodalScenario, ChurnScenario,
                                     DiurnalScenario, HeavyTailScenario,
                                     PaperDefaultScenario)

__all__ = [
    "FactorSampler", "Scenario", "TimeModel", "TimeModelSpec",
    "get_scenario", "register_scenario", "scenario_names",
    "PaperDefaultScenario", "HeavyTailScenario", "BimodalScenario",
    "DiurnalScenario", "ChurnScenario",
]
