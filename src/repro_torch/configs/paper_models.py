"""The paper's own experiment-scale language model (fidelity experiments, §6).

The paper's LSTM next-character task on Shakespeare is stood in for by a
small dense decoder trained on the synthetic non-iid ``CharLMData``; the
2-NN lives in ``repro_torch/xp/builders.py``.
"""
from repro_torch.configs.base import ModelConfig, register

# Next-character LM standing in for the paper's LSTM (Table 7 scale).
CONFIG_CHAR_LM = register(ModelConfig(
    name="paper-char-lm",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=80,          # Shakespeare character vocabulary
    param_dtype="float32",
    compute_dtype="float32",
    source="paper §6 (LSTM task stand-in)",
))
