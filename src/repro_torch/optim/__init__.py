"""Optimizers and learning-rate schedules (the port of ``repro/optim``)."""
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (REGISTRY, AdamState, Optimizer,
                                          adamw, apply_updates, make,
                                          momentum, sgd)

__all__ = ["schedules", "REGISTRY", "AdamState", "Optimizer", "adamw",
           "apply_updates", "make", "momentum", "sgd"]
