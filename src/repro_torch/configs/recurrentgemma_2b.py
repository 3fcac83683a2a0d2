"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1:2 [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,           # MQA for the local-attention blocks
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),  # 1 local-attn : 2 recurrent
    rnn_width=2560,
    conv_width=4,
    attn_window=2048,       # Griffin local attention window
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    notes="RG-LRU recurrence + 2048-window local attn; native long_500k",
))
