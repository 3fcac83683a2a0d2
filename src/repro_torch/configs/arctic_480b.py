"""Snowflake Arctic 480B — 128-expert top-2 MoE + dense residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,           # GQA kv=8
    d_ff=4864,              # per-expert FFN width
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    dense_residual_ff=4864,  # dense-MoE hybrid: dense MLP residual in parallel
    moe_groups=16,           # GShard dispatch groups = data-shard count
    source="hf:Snowflake/snowflake-arctic-base",
    notes="128e top-2 + dense residual; heaviest replica — hierarchical worker/fsdp split",
))
