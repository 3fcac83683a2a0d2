"""Grok-1 314B — MoE, 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,           # GQA kv=8
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    moe_groups=16,           # GShard dispatch groups = data-shard count
    source="hf:xai-org/grok-1",
    notes="8-expert top-2 MoE; expert-parallel over the model axis",
))
