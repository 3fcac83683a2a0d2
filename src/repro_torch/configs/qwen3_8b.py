"""Qwen3-8B — dense GQA with qk_norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,           # GQA kv=8
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,           # per-head RMSNorm on q and k
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
    notes="qk_norm GQA; long_500k via swa8192 variant",
))
