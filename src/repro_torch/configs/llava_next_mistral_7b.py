"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision frontend (SigLIP/CLIP ViT + projector) is a stub:
``models.multimodal.make_stub_prefix`` provides the projected patch
embeddings (anyres tiling → up to 2880 patches = 4 tiles + base, 576 patches
each) prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,           # GQA kv=8
    d_ff=14336,
    vocab_size=32000,
    frontend="vision",
    n_prefix_tokens=2880,   # anyres: 5 tiles x 576 projected patches
    rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    notes="anyres tiling stubbed as precomputed patch embeddings",
))
