"""Token-stream data pipeline for the framework-scale training examples.

A copy of the reference's ``TokenStream`` (``repro/data/pipeline.py``):
each worker draws from its own document stream -- the decentralized
analogue of the paper's per-worker local datasets -- with deterministic,
resumable cursors.  The same seeds give the same tokens, bit for bit;
batches stay NumPy ``int32``, and the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_workers: int = 1
    seed: int = 0
    zipf_s: float = 1.2          # token frequency skew
    worker_shift: float = 0.25   # per-worker distribution rotation (non-iid)


class TokenStream:
    """Deterministic synthetic token stream (Zipf unigram + worker shift)."""

    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_workers:
            raise ValueError("global_batch must divide evenly across workers")
        self.per_worker = cfg.global_batch // cfg.n_workers
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._base = 1.0 / ranks ** cfg.zipf_s
        self._cursor = np.zeros(cfg.n_workers, dtype=np.int64)

    def _probs(self, worker: int) -> np.ndarray:
        shift = int(self.cfg.worker_shift * worker * self.cfg.vocab_size
                    / max(1, self.cfg.n_workers))
        p = np.roll(self._base, shift)
        return p / p.sum()

    def worker_batch(self, worker: int, step: Optional[int] = None) -> Dict:
        step = int(self._cursor[worker]) if step is None else step
        self._cursor[worker] = step + 1
        rng = np.random.default_rng((self.cfg.seed, worker, step))
        toks = rng.choice(self.cfg.vocab_size, p=self._probs(worker),
                          size=(self.per_worker, self.cfg.seq_len))
        return {"tokens": toks.astype(np.int32)}

    def global_batch(self, step: Optional[int] = None) -> Dict:
        parts = [self.worker_batch(w, step)["tokens"]
                 for w in range(self.cfg.n_workers)]
        return {"tokens": np.concatenate(parts, axis=0)}

    # -- checkpointing ----------------------------------------------------
    def state_dict(self) -> Dict:
        return {"cursor": self._cursor.copy()}

    def load_state_dict(self, state: Dict) -> None:
        self._cursor = np.asarray(state["cursor"], dtype=np.int64).copy()

    def __iter__(self) -> Iterator[Dict]:
        while True:
            yield self.global_batch()
