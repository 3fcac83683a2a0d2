"""Declarative experiment specification.

An :class:`ExperimentSpec` names everything that determines a paper-figure
sweep — algorithm set, topology, scenario set, scales, seeds, budgets,
execution mode and dtype policy — so a recorded artifact
(``BENCH_paper_figures.json``) embeds the spec and is exactly reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

KNOWN_ALGS = ("dsgd_aau", "dsgd_sync", "ad_psgd", "prague", "agp")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """algorithm × topology × scenario × scale × seeds, plus budgets.

    Budget semantics: each run is bounded by ``max_events`` if set, else by
    virtual time — ``max_time`` for the asynchronous algorithms and
    ``ref_max_time`` for the synchronous reference (the reference needs far
    more virtual time per iteration: every barrier waits for the slowest of
    n workers).  When ``time_scaled`` is on, time budgets are multiplied by
    the scenario's ``mean_duration_factor()`` so heavy-tailed regimes get
    the same effective number of local computations; batch pools are sized
    from that scaled budget (see ``repro.xp.sweep._budgets``), which bounds
    restarts per worker even for a worker that only draws fast durations.
    """

    name: str = "experiment"
    algorithms: Tuple[str, ...] = ("dsgd_aau", "ad_psgd", "prague", "agp")
    reference: Optional[str] = "dsgd_sync"
    scenarios: Tuple[str, ...] = ("paper_default",)
    scenario_kw: Mapping[str, Mapping[str, object]] = \
        dataclasses.field(default_factory=dict)
    scales: Tuple[int, ...] = (16, 32)
    seeds: Tuple[int, ...] = (0,)
    topology: str = "erdos_renyi"
    topology_kw: Mapping[str, object] = dataclasses.field(default_factory=dict)
    partition: str = "label_shard"
    data_seed: int = 0

    # execution
    mode: str = "sparse_scan"
    dtype: str = "float32"
    block_size: int = 32
    batch_pool: Optional[int] = None     # None → derived from the budget
    group_size: int = 4                  # prague
    horizon: Optional[int] = None        # single-edge event-horizon batching
    telemetry: bool = False              # device-resident per-worker counters
                                         # (repro.obs) recorded per cell
    trace: bool = False                  # event-identity tracing: wait-blame
                                         # / critical-path summary
                                         # (repro.obs.trace) per cell
    run_log: Optional[str] = None        # JSONL structured run-log path

    # budgets
    max_events: Optional[int] = None
    max_time: Optional[float] = 60.0
    ref_max_time: Optional[float] = 400.0
    ref_max_events: int = 160
    time_scaled: bool = True
    eval_every: int = 10
    ref_eval_every: int = 2

    # measurement
    target_loss: float = 0.9
    eta0: float = 0.2
    eta_decay: float = 0.999
    dtype_probe: bool = False            # record a bf16-vs-fp32 artifact row
    dtype_probe_events: int = 200

    def __post_init__(self):
        for field in ("algorithms", "scenarios", "scales", "seeds"):
            if not getattr(self, field):
                raise ValueError(f"spec needs at least one entry in {field}")
        for alg in self.algorithms + ((self.reference,) if self.reference else ()):
            if alg not in KNOWN_ALGS:
                raise KeyError(f"unknown algorithm {alg!r}; have {KNOWN_ALGS}")
        if self.mode not in ("scan", "sparse_scan", "per_event", "auto",
                             "fused"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "fused" and self.max_time is not None:
            raise ValueError(
                "mode='fused' keeps the virtual clock on device and is "
                "bounded by max_events only; set max_time=None")
        if not (self.max_events or self.max_time):
            raise ValueError("spec needs max_events or max_time")
        if any(n < 2 for n in self.scales):
            raise ValueError("scales must be worker counts >= 2")

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["scenario_kw"] = {k: dict(v) for k, v in self.scenario_kw.items()}
        d["topology_kw"] = dict(self.topology_kw)
        return d
