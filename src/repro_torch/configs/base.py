"""Architecture configuration of the port's language models.

The port of the reference's ``repro/configs/base.py``: ``reduced()`` and
the registry, with torch dtypes.  :class:`ModelConfig` holds only the
reference's fields that the ported families read (hybrid, dense and
moe); each later family adds its own, so a config cannot ask for an option
the port would silently leave out.  Each architecture is a module under
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
    family: str                       # hybrid | dense | moe (the others are not ported)
    n_layers: int
    d_model: int
    n_heads: int
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

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head) of a dense
        or MoE config, the reference's formula (``repro/configs/base.py``)."""
        if self.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"param_count() covers the dense and moe families; {self.name} "
                f"is {self.family!r} (transformer.param_count counts any ported "
                "model from its shapes)")
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = v * d + d                               # embed, final norm
        if not self.tie_embeddings:
            total += d * v                              # lm head
        per_attn = (d * self.n_heads * self.d_head     # wq
                    + 2 * d * self.n_kv_heads * self.d_head  # wk, wv
                    + self.n_heads * self.d_head * d)   # wo
        if self.qk_norm:
            per_attn += 2 * self.d_head
        if self.family == "moe":
            per_ffn = self.n_experts * 3 * d * f + d * self.n_experts
            if self.dense_residual_ff:
                per_ffn += 3 * d * self.dense_residual_ff
        else:
            per_ffn = 3 * d * f
        return total + L * (per_attn + per_ffn + 2 * d)

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
