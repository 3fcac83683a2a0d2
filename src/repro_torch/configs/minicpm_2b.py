"""MiniCPM-2B — llama-like dense, trained with the WSD schedule [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,          # GQA kv=36 (i.e. MHA)
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,    # MiniCPM ties input/output embeddings
    source="arXiv:2404.06395 (MiniCPM)",
    notes="WSD schedule implemented in repro.optim.schedules.wsd",
))
