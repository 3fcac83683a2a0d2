"""DeepSeek-67B — dense llama-arch [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,           # GQA kv=8
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    source="arXiv:2401.02954 (DeepSeek LLM 67B)",
    notes="llama-arch dense; long_500k runs via the swa8192 variant",
))
