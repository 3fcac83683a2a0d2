"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The audio frontend (EnCodec + mel feature extraction) is a stub:
``models.multimodal.make_stub_prefix`` supplies the conditioning frame
embeddings; the decoder consumes EnCodec token ids (vocab 2048) directly.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,          # GQA kv=32 (MHA)
    d_ff=8192,
    vocab_size=2048,        # EnCodec codebook size
    frontend="audio",
    n_prefix_tokens=256,    # conditioning frame embeddings (stub frontend)
    source="arXiv:2306.05284 (MusicGen)",
    notes="decoder-only over EnCodec tokens; long_500k via swa8192 variant",
))
