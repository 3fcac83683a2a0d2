"""The benchmark's inputs, made from ``--seed`` and handed to both the
program and the plain reference: the topology, the stragglers' compute
times, the character data, the token draws and the model weights.

One general generator per kind of input, driven by the parameters of a
traffic file (``traffic/*.json``) and a configuration file
(``configs/*.json``).  Nothing here imports the program: the program gets
what these functions return (arrays, a time model with the scheduler's
sampler surface, weight dicts under the program's parameter names).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A NumPy generator of its own for each named stream of one seed."""
    return np.random.default_rng((int(seed),) + tuple(int(s) for s in stream))


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    frontier = np.array([0])
    while frontier.size:
        nxt = np.flatnonzero(adj[frontier].any(axis=0) & ~seen)
        seen[nxt] = True
        frontier = nxt
    return bool(seen.all())


def topology(spec: dict, n: int, seed: int) -> np.ndarray:
    """(n, n) symmetric bool adjacency, zero diagonal.

    ``erdos_renyi``: each pair an edge with probability ``p`` (default
    max(0.15, 4/n), the paper's random connected graph), then, if the draw
    is not connected, a random Hamiltonian cycle's edges added.  The
    spec's own ``seed``, where given, fixes the graph for every run (the
    paper keeps one graph); else it is drawn from the run's seed."""
    if spec["kind"] != "erdos_renyi":
        raise ValueError(f"unknown topology {spec['kind']!r}")
    p = spec.get("p") or max(0.15, 4.0 / n)
    rng = (np.random.default_rng(spec["seed"]) if "seed" in spec
           else _rng(seed, 1))
    adj = np.triu(rng.random((n, n)) < p, k=1)
    adj = adj | adj.T
    if not _connected(adj):
        perm = rng.permutation(n)
        adj[perm, np.roll(perm, 1)] = True
        adj[np.roll(perm, 1), perm] = True
        np.fill_diagonal(adj, False)
    return adj


class StragglerTimes:
    """The stragglers' compute times as a pure function of (worker, draw):
    the k-th local computation of worker w takes ``base`` times a factor
    drawn once, from the seed, into an (n, K) table (lognormal jitter times
    ``slowdown`` with probability ``straggler_prob``: the paper's §6
    protocol).  A worker past K draws wraps to its first.

    It carries what the DSGD-AAU and synchronous schedulers draw through
    (``n``, ``make_sampler``; the sampler's ``base``, ``sample_batch``,
    ``sample_all``), and the reference reads ``duration`` directly, so
    both sides see the same times whatever order they draw them in."""

    def __init__(self, spec: dict, n: int, seed: int, draws: int = 4096):
        if spec["kind"] != "paper_default":
            raise ValueError(f"unknown straggler model {spec['kind']!r}")
        rng = _rng(seed, 2)
        f = rng.lognormal(0.0, spec["jitter"], size=(n, draws))
        slow = rng.random((n, draws)) < spec["straggler_prob"]
        self.factors = np.where(slow, f * spec["slowdown"], f)
        self.n = n
        self.base = np.full(n, float(spec["base_time"]))
        self.count = np.zeros(n, dtype=np.int64)

    def duration(self, worker: int, k: int) -> float:
        return float(self.base[worker]
                     * self.factors[worker, k % self.factors.shape[1]])

    # -- the scheduler's surface ---------------------------------------------
    def make_sampler(self) -> "StragglerTimes":
        return self

    def sample_batch(self, workers) -> np.ndarray:
        w = np.asarray(workers, dtype=np.int64).reshape(-1)
        k = self.count[w] % self.factors.shape[1]
        self.count[w] += 1
        return self.base[w] * self.factors[w, k]

    def sample_all(self) -> np.ndarray:
        return self.sample_batch(np.arange(self.n))


def charlm_pool(spec: dict, n: int, vocab: int, seed: int):
    """Non-iid character streams: worker w's Markov chain over ``vocab``
    characters has its own transition temperature (spread
    ``temperature_spread`` across workers).  Returns (pool, eval): pool
    (n, pool, batch, seq_len) int64 -- the s-th batch worker w draws is
    pool[w, s] -- and eval (eval_batch, seq_len) from the workers' mean
    chain.  Every chain is advanced for all sequences at once."""
    rng = _rng(seed, 3)
    base = rng.normal(size=(vocab, vocab))
    temp = 1.0 + spec["temperature_spread"] * (
        np.arange(n) / max(1, n - 1) - 0.5)
    logits = (base[None] / temp[:, None, None]
              + 0.1 * rng.normal(size=(n, vocab, vocab)))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    trans = p / p.sum(-1, keepdims=True)                      # (n, V, V)
    shape = (n, spec["pool"], spec["batch"])
    chain = np.broadcast_to(np.arange(n)[:, None, None], shape).reshape(-1)
    pool = _markov(np.cumsum(trans, -1), chain, spec["seq_len"], rng)
    avg = trans.mean(0)
    avg = avg / avg.sum(-1, keepdims=True)
    ev = _markov(np.cumsum(avg, -1)[None],
                 np.zeros(spec["eval_batch"], dtype=np.int64),
                 spec["seq_len"], rng)
    return pool.reshape(shape + (spec["seq_len"],)), ev


def _markov(cdf: np.ndarray, chain: np.ndarray, length: int,
            rng: np.random.Generator) -> np.ndarray:
    """Streams of ``length`` from the chains ``cdf[chain]`` (rows of
    cumulative transition probabilities), a uniform start each."""
    vocab = cdf.shape[-1]
    out = np.empty((chain.size, length), dtype=np.int64)
    s = rng.integers(0, vocab, size=chain.size)
    u = rng.random((length, chain.size))
    for t in range(length):
        out[:, t] = s
        s = np.minimum((cdf[chain, s] < u[t][:, None]).sum(-1), vocab - 1)
    return out


def tokens(spec: dict, workers: int, vocab: int, steps: int, seed: int,
           device) -> torch.Tensor:
    """(steps, workers, batch, seq_len) token ids, uniform over the
    vocabulary, drawn on ``device`` from the seed in one call: every row
    differs."""
    g = torch.Generator(device=device).manual_seed(_seed64(seed, 4))
    return torch.randint(0, vocab, (steps, workers, spec["batch"],
                                    spec["seq_len"]),
                         generator=g, device=device)


def straggler_rounds(prob: float, steps: int, seed: int) -> np.ndarray:
    """(steps,) bool: the rounds in which a straggler zeroes the ring's
    neighbour weights."""
    return _rng(seed, 5).random(steps) < prob


def _seed64(seed: int, *stream: int) -> int:
    return int(np.random.SeedSequence((int(seed),) + stream)
               .generate_state(1, np.uint64)[0]) >> 1


# -- weights -----------------------------------------------------------------

def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """The dense decoder's leaves under the program's parameter names
    (layer-stacked: a leading layer axis), in the program's order."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // H
    f, V = cfg["intermediate_size"], cfg["vocab_size"]
    shapes = {"embed.table": (V, d),
              "layers.ln1.scale": (L, d),
              "layers.attn.wq": (L, d, H * dh),
              "layers.attn.wk": (L, d, KV * dh),
              "layers.attn.wv": (L, d, KV * dh),
              "layers.attn.wo": (L, H * dh, d),
              "layers.ln2.scale": (L, d),
              "layers.ffn.w_gate": (L, d, f),
              "layers.ffn.w_up": (L, d, f),
              "layers.ffn.w_down": (L, f, d),
              "final_norm.scale": (d,)}
    if not cfg["tie_word_embeddings"]:
        shapes["head.w"] = (d, V)
    return shapes


def dtype_of(cfg: dict) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg["torch_dtype"]]


def init_leaf(cfg: dict, key: str, seed: int, device) -> torch.Tensor:
    """One leaf of the initial weights, drawn on ``device`` in one call from
    a generator of its own (so any leaf can be drawn again alone): norm
    scales 1, the embedding and the head N(0, 0.02²), every other matrix
    N(0, 1/fan_in) of its per-layer (in, out) shape; in the configuration's
    dtype."""
    shape = param_shapes(cfg)[key]
    dt = dtype_of(cfg)
    if key.endswith(".scale"):
        return torch.ones(shape, dtype=dt, device=device)
    scale = (0.02 if key in ("embed.table", "head.w")
             else 1.0 / math.sqrt(shape[-2]))
    index = list(param_shapes(cfg)).index(key)
    g = torch.Generator(device=device).manual_seed(_seed64(seed, 6, index))
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dt)


def init_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """One replica of the initial weights, leaf by leaf (``init_leaf``)."""
    return {k: init_leaf(cfg, k, seed, device) for k in param_shapes(cfg)}
