"""RWKV6 (Finch) 1.6B — attention-free SSM, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892 (Eagle & Finch: RWKV-5/6)",
    notes="data-dependent decay; O(1) decode state; native long_500k",
))
