"""Architecture configuration of the port's language models.

The port of the reference's ``repro/configs/base.py``: the reference's
fields, ``param_count()``, ``reduced()`` and the registry, with torch
dtypes.  Every family of the reference is ported (dense, moe, ssm,
hybrid, audio, vlm).  Each architecture is a module under
``repro_torch/configs/`` that registers its config on import.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                   # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual_ff: int = 0        # arctic: dense MLP in parallel with MoE
    moe_capacity_factor: float = 1.25  # Switch-style expert capacity
    moe_groups: int = 1               # GShard-style dispatch groups
    # --- attention details ---
    qk_norm: bool = False             # qwen3: per-head RMSNorm on q and k
    rope_theta: float = 10000.0
    attn_window: Optional[int] = None  # sliding-window attention (tokens)
    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    rnn_width: int = 0                # RG-LRU state width (default d_model)
    conv_width: int = 4
    # --- ssm (rwkv6) ---
    rwkv_head_dim: int = 64
    # --- multimodal stub frontend ---
    frontend: Optional[str] = None    # None | "audio" | "vision"
    n_prefix_tokens: int = 0          # patch/frame embeddings prepended
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    source: str = ""                  # citation of paper / model card
    notes: str = ""

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.family == "hybrid" and self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path available (native SSM/hybrid or SWA variant)."""
        return True  # every arch has SSM/hybrid recurrence or the SWA variant

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        """SWA variant used for the long_500k decode shape on quadratic archs."""
        if self.family == "ssm":
            return self  # natively O(1) state
        return dataclasses.replace(self, attn_window=window,
                                   notes=self.notes + f" [swa{window} variant]")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula (``repro/configs/base.py``): exact for the
        dense, moe, audio and vlm families, approximate for ssm (12·d² a
        layer) and hybrid; ``transformer.param_count`` counts any model
        exactly from its shapes."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = v * d + d                               # embed, final norm
        if not self.tie_embeddings:
            total += d * v                              # lm head
        per_attn = (d * self.n_heads * self.d_head     # wq
                    + 2 * d * self.n_kv_heads * self.d_head  # wk, wv
                    + self.n_heads * self.d_head * d)   # wo
        if self.qk_norm:
            per_attn += 2 * self.d_head
        per_mlp_dense = 3 * d * f
        per_norms = 2 * d
        if self.family == "moe":
            per_ffn = self.n_experts * 3 * d * f + d * self.n_experts
            if self.dense_residual_ff:
                per_ffn += 3 * d * self.dense_residual_ff
        else:
            per_ffn = per_mlp_dense
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o,decay lora) + channel-mix, roughly 12 d²
            return total + L * (12 * d * d + per_norms)
        if self.family == "hybrid":
            n_attn = sum(1 for b in self._pattern_expanded() if b == "attn")
            w = self.rnn_width
            per_rec = (2 * d * w              # in/gate proj
                       + self.conv_width * w  # conv1d
                       + 2 * w                # RG-LRU gates' diagonal params
                       + 2 * w * d            # rec gates (input/recurrence)
                       + w * d                # out proj
                       + 2 * w * w // max(w, 1))
            return (total + n_attn * (per_attn + per_mlp_dense + per_norms)
                    + (L - n_attn) * (per_rec + per_mlp_dense + per_norms))
        return total + L * (per_attn + per_ffn + per_norms)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        per_expert = 3 * self.d_model * self.d_ff
        return (self.param_count()
                - self.n_layers * (self.n_experts - self.top_k) * per_expert)

    def _pattern_expanded(self) -> Tuple[str, ...]:
        if not self.block_pattern:
            return tuple(["attn"] * self.n_layers)
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family and features, tiny dims (the
        reference's rules, so both packages reduce a config alike)."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4) if self.n_heads else 0
        kv = min(self.n_kv_heads, heads) if heads else 0
        if kv and heads % kv:
            kv = 1
        pattern = self.block_pattern[: 3] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 if not pattern else len(pattern),
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            d_head=d // heads if heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_groups=1,
            dense_residual_ff=(min(self.dense_residual_ff, 256)
                               if self.dense_residual_ff else 0),
            rnn_width=min(self.rnn_width, d) if self.rnn_width else 0,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            n_prefix_tokens=(min(self.n_prefix_tokens, 8)
                             if self.n_prefix_tokens else 0),
            param_dtype="float32",
            compute_dtype="float32",
        )


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[name]
