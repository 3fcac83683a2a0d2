"""Assigned input shapes and abstract input specs for the dry run.

The port of ``repro/launch/shapes.py``.  The ``*_input_specs`` functions
return (inputs, specs) for every (architecture × input shape × mode): the
inputs are tensors on the ``meta`` device (shape and dtype, no allocation,
even for decode_32k's ~600 GB of KV cache), the specs the sharding
policy's tuples (``launch/sharding.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import TrainAxes, axis_sizes
from repro_torch.launch.sharding import batch_pspec, serve_pspecs
from repro_torch.models.layers import KVCache
from repro_torch.models.transformer import STACKED, init_decode_state


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}

SWA_WINDOW = 8192  # rolling window for the long_500k variant on quadratic archs


def shape_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Arch variant actually run for this shape (SWA for long_500k)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.with_sliding_window(SWA_WINDOW)
    return cfg


def meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """An abstract input: shape and dtype, on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Train inputs: batch stacked per worker — {tokens (nw, B_w, S), [prefix]}
# ---------------------------------------------------------------------------

def train_input_specs(cfg: ModelConfig, shape: InputShape, n_workers: int,
                      axes: TrainAxes, *, seq_shard: bool = True):
    if shape.global_batch % n_workers:
        raise ValueError(f"{shape.global_batch} batch !% {n_workers} workers")
    bw = shape.global_batch // n_workers
    batch = {"tokens": meta((n_workers, bw, shape.seq_len), torch.int32)}
    if cfg.frontend:
        batch["prefix"] = meta((n_workers, bw, cfg.n_prefix_tokens, cfg.d_model),
                               cfg.cdtype)
    specs = batch_pspec(batch, axes.worker_axes, axes.fsdp,
                        seq_axis=axes.model if seq_shard else None)
    return batch, specs


# ---------------------------------------------------------------------------
# Serve inputs (decode): token (B,), state, pos scalar
# ---------------------------------------------------------------------------

def data_axes(mesh):
    """The data-like axis for serving: ("pod", "data") on the multi-pod mesh."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else "data"


def _data_size(mesh, da) -> int:
    sizes = axis_sizes(mesh)
    return (sizes["pod"] * sizes["data"] if isinstance(da, tuple)
            else sizes["data"])


def stack_layers(cfg: ModelConfig, state):
    """The reference's layout of a decode state: one layer-stacked state,
    every leaf (L, ...), for the homogeneous families; the per-layer tuple
    as it is for the hybrid.  (The port's decode step takes the tuple;
    this layout is for the specs and shapes only.)"""
    if cfg.family not in STACKED:
        return state
    first = state[0]
    if isinstance(first, KVCache):
        return KVCache(**{f: torch.stack([getattr(s, f) for s in state])
                          for f in ("k", "v", "positions")})
    return type(first)(*(torch.stack(xs) for xs in zip(*state)))


def decode_input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """({"token", "state", "pos"}, specs) of one decode step, the state
    filled to ``seq_len`` and in the reference's layout (``stack_layers``),
    so that its shapes and specs are the reference's leaf for leaf."""
    B = shape.global_batch
    da = data_axes(mesh)
    dsize = _data_size(mesh, da)
    state = stack_layers(cfg, init_decode_state(cfg, B, shape.seq_len,
                                                device="meta", filled=True))
    token = meta((B,), torch.int32)
    pos = meta((), torch.int32)
    state_specs = serve_pspecs(state, mesh, data=da)
    token_spec = (da,) if B % dsize == 0 else (
        ("data",) if B % axis_sizes(mesh)["data"] == 0 else ())
    return ({"token": token, "state": state, "pos": pos},
            {"token": token_spec, "state": state_specs, "pos": ()})


# ---------------------------------------------------------------------------
# Prefill inputs: tokens (B, S) [+ prefix]
# ---------------------------------------------------------------------------

def prefill_input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    B = shape.global_batch
    da = data_axes(mesh)
    dsize = _data_size(mesh, da)
    baxis = da if B % dsize == 0 else (
        "data" if B % axis_sizes(mesh)["data"] == 0 else None)
    batch = {"tokens": meta((B, shape.seq_len), torch.int32)}
    specs = {"tokens": (baxis, "model")}
    if cfg.frontend:
        batch["prefix"] = meta((B, cfg.n_prefix_tokens, cfg.d_model), cfg.cdtype)
        specs["prefix"] = (baxis, None, None)
    return batch, specs
