"""Experiment specification and the builders of one experiment cell."""
from repro_torch.xp.builders import (build_graph, build_scenario,
                                     build_trainer, mlp2nn_eval, mlp2nn_init,
                                     mlp2nn_loss, params_from_numpy)
from repro_torch.xp.spec import KNOWN_ALGS, ExperimentSpec

__all__ = ["build_graph", "build_scenario", "build_trainer", "mlp2nn_eval",
           "mlp2nn_init", "mlp2nn_loss", "params_from_numpy", "KNOWN_ALGS",
           "ExperimentSpec"]
