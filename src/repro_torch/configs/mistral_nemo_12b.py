"""Mistral-NeMo 12B — dense GQA, 128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,           # GQA kv=8
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,  # 128k-context rope base
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    notes="128k ctx; long_500k via Mistral-style rolling-window swa8192 variant",
))
