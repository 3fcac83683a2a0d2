"""Synthetic datasets with controllable non-iid-ness across workers.

Copies of the reference's ``repro/data/synthetic.py``, drawing the same
samples from the same seeds:

  * ``ClassificationData`` — Gaussian-mixture classes with the paper's
    label-sharding partitioner, a Dirichlet partitioner, or iid;
  * ``CharLMData`` — Markov-chain character streams; each worker's chain has
    a distinct transition temperature (heterogeneous local distributions),
    standing in for per-speaker Shakespeare shards.

Batches stay NumPy: the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class ClassificationData:
    n_workers: int
    d: int = 64
    n_classes: int = 10
    samples_per_worker: int = 512
    classes_per_worker: int = 5          # paper: 5 of 10 classes per worker
    partition: str = "label_shard"       # or "dirichlet" / "iid"
    dirichlet_alpha: float = 0.3
    noise: float = 0.5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class prototypes
        self.protos = rng.normal(size=(self.n_classes, self.d)).astype(np.float32)
        # per-worker class distributions
        if self.partition == "iid":
            probs = np.full((self.n_workers, self.n_classes), 1.0 / self.n_classes)
        elif self.partition == "dirichlet":
            probs = rng.dirichlet([self.dirichlet_alpha] * self.n_classes,
                                  size=self.n_workers)
        elif self.partition == "label_shard":
            probs = np.zeros((self.n_workers, self.n_classes))
            for w in range(self.n_workers):
                classes = rng.choice(self.n_classes,
                                     size=min(self.classes_per_worker, self.n_classes),
                                     replace=False)
                probs[w, classes] = 1.0 / len(classes)
        else:
            raise ValueError(self.partition)
        self.class_probs = probs
        self._worker_data: Dict[int, tuple] = {}
        for w in range(self.n_workers):
            r = np.random.default_rng(self.seed * 7919 + w)
            labels = r.choice(self.n_classes, size=self.samples_per_worker,
                              p=probs[w])
            x = (self.protos[labels]
                 + self.noise * r.normal(size=(self.samples_per_worker, self.d))
                 ).astype(np.float32)
            self._worker_data[w] = (x, labels.astype(np.int32))

    def batch(self, worker: int, step: int, batch_size: int = 64):
        x, y = self._worker_data[worker]
        r = np.random.default_rng((self.seed, worker, step))
        idx = r.integers(0, len(y), size=batch_size)
        return {"x": x[idx], "y": y[idx]}

    def eval_batch(self, batch_size: int = 1024):
        """Held-out iid batch from the global mixture."""
        r = np.random.default_rng(self.seed + 123456)
        labels = r.choice(self.n_classes, size=batch_size)
        x = (self.protos[labels]
             + self.noise * r.normal(size=(batch_size, self.d))).astype(np.float32)
        return {"x": x, "y": labels.astype(np.int32)}

    def heterogeneity(self) -> float:
        """TV distance of worker label distributions from uniform (ς proxy)."""
        u = 1.0 / self.n_classes
        return float(np.mean(np.abs(self.class_probs - u).sum(1) / 2))


@dataclasses.dataclass
class CharLMData:
    n_workers: int
    vocab: int = 80
    seq_len: int = 64
    temperature_spread: float = 0.5     # worker-to-worker distribution shift
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        base = rng.normal(size=(self.vocab, self.vocab))
        self._trans: List[np.ndarray] = []
        for w in range(self.n_workers):
            temp = 1.0 + self.temperature_spread * (w / max(1, self.n_workers - 1) - 0.5)
            logits = base / temp + 0.1 * rng.normal(size=base.shape)
            p = np.exp(logits - logits.max(1, keepdims=True))
            self._trans.append(p / p.sum(1, keepdims=True))

    def _sample_stream(self, trans, rng, length):
        out = np.empty(length, dtype=np.int32)
        s = rng.integers(0, self.vocab)
        for t in range(length):
            out[t] = s
            s = rng.choice(self.vocab, p=trans[s])
        return out

    def batch(self, worker: int, step: int, batch_size: int = 16):
        rng = np.random.default_rng((self.seed, worker, step))
        toks = np.stack([
            self._sample_stream(self._trans[worker], rng, self.seq_len)
            for _ in range(batch_size)])
        return {"tokens": toks}

    def eval_batch(self, batch_size: int = 32):
        rng = np.random.default_rng(self.seed + 999)
        avg = np.mean(np.stack(self._trans), axis=0)
        avg = avg / avg.sum(1, keepdims=True)
        toks = np.stack([
            self._sample_stream(avg, rng, self.seq_len) for _ in range(batch_size)])
        return {"tokens": toks}
