"""Per-architecture training settings of the reference's production meshes
(``repro/launch/mesh.py``).  Only the gradient-accumulation table is
ported so far: the meshes, ``hierarchical_view`` and ``train_view``
belong to the sharded launch stack (ROADMAP A5).  On one card the workers
are a stacked leading axis and ``launch/train.py`` takes their number from
``--workers``.
"""
from __future__ import annotations

from typing import Dict

# Gradient-accumulation microbatches for activation-heavy train configs.
MICROBATCH: Dict[str, int] = {
    "deepseek-67b": 2,
    "grok-1-314b": 2,
    # arctic: the reference measured float32 accumulation buffers costing
    # more than microbatching saves; a single batch + remat is better.
}
