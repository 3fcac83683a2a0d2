"""Config-driven experiment harness: paper figures as declarative sweeps.

The port of the reference's ``repro/xp``: ``ExperimentSpec`` names an
algorithm × topology × scenario × scale × seeds sweep; ``run_spec``
executes it on the card (or the CPU when asked) with mean±std aggregation;
``artifact_payload``/``write_artifact`` emit the ``BENCH_paper_figures.json``
schema and the benchmark CSV rows.  ``python -m repro_torch.xp`` is the CLI.
"""
from repro_torch.xp.artifacts import (artifact_payload, csv_rows,
                                      load_artifact, write_artifact)
from repro_torch.xp.builders import (build_graph, build_scenario,
                                     build_trainer, mlp2nn_eval, mlp2nn_init,
                                     mlp2nn_loss, params_from_numpy)
from repro_torch.xp.presets import get_preset, paper_figures_spec, smoke_spec
from repro_torch.xp.spec import KNOWN_ALGS, ExperimentSpec
from repro_torch.xp.sweep import (RunRecord, SweepResult, convergence_rows,
                                  dtype_probe_rows, run_cell, run_spec,
                                  speedup_rows)

__all__ = [
    "ExperimentSpec", "KNOWN_ALGS", "RunRecord", "SweepResult",
    "artifact_payload", "csv_rows", "load_artifact", "write_artifact",
    "build_graph", "build_scenario", "build_trainer",
    "mlp2nn_eval", "mlp2nn_init", "mlp2nn_loss", "params_from_numpy",
    "get_preset", "paper_figures_spec", "smoke_spec",
    "convergence_rows", "dtype_probe_rows", "run_cell", "run_spec",
    "speedup_rows",
]
