"""Carry a language model's weights over from the reference.

``lm_params_from_numpy`` takes the reference's ``init_model`` pytree with
its leaves fetched to the host as NumPy arrays (nested dicts; the hybrid
family's layers a tuple, indexed ``layers.{i}``; every other family's
layers one dict of layer-stacked leaves: ``layers.attn.wq`` of shape (L, d,
H·dh) for dense, moe, audio and vlm, ``layers.ffn.w_gate`` of an MoE (L, E,
d, f), arctic's ``layers.ffn.dense_residual.w_up``, and for ssm
``layers.time_mix.*`` (``w_r`` (L, d, d), ``bonus_u`` (L, H, K),
``out_norm.scale``) and ``layers.channel_mix.*``) and returns the port's model holding
the same values, so both packages compute the same function.
``lm_flat_params_from_numpy`` returns the same weights as the flat dict
one worker of a decentralized trainer holds; ``load_numpy`` fills any of
the port's modules (one ``models.moe.MoE``, say) from the matching
subtree.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import LM, flat_params, init_model


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def load_numpy(module: nn.Module, tree: Any) -> nn.Module:
    """``module`` with the pytree's weights loaded, cast to each
    parameter's dtype.  Keys and shapes must match the module's exactly (a
    missing, extra or mis-shaped leaf raises)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    own = module.state_dict()
    if set(flat) != set(own):
        raise KeyError(f"pytree and model disagree: only in the pytree "
                       f"{sorted(set(flat) - set(own))}, only in the model "
                       f"{sorted(set(own) - set(flat))}")
    for k, t in own.items():
        if tuple(flat[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: pytree shape {flat[k].shape} != model "
                             f"shape {tuple(t.shape)}")
    module.load_state_dict({k: torch.from_numpy(np.array(
        flat[k], dtype=np.float32)).to(own[k].dtype) for k in own})
    return module


def lm_params_from_numpy(tree: Any, cfg: ModelConfig,
                         device: DeviceLike = "cuda") -> LM:
    """The port's model on ``device`` with the pytree's weights
    (``load_numpy``'s checks)."""
    return load_numpy(init_model(cfg, None, device), tree)


def lm_flat_params_from_numpy(tree: Any, cfg: ModelConfig,
                              device: DeviceLike = "cuda"
                              ) -> Dict[str, torch.Tensor]:
    """The pytree's weights as the flat ``{path: tensor}`` dict that
    ``lm_loss`` takes and a trainer stacks per worker."""
    return {k: p.detach()
            for k, p in flat_params(lm_params_from_numpy(tree, cfg, device)).items()}
