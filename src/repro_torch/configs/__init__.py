"""Architecture registry of the port.  Importing this package registers the
reference's eleven archs: hybrid (recurrentgemma-2b), dense (qwen3-8b,
minicpm-2b, mistral-nemo-12b, deepseek-67b, paper-char-lm), moe
(grok-1-314b, arctic-480b), ssm (rwkv6-1.6b), audio (musicgen-large) and
vlm (llava-next-mistral-7b)."""
from repro_torch.configs.base import ModelConfig, get_config, register
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    deepseek_67b,
    grok_1_314b,
    llava_next_mistral_7b,
    minicpm_2b,
    mistral_nemo_12b,
    musicgen_large,
    paper_models,
    qwen3_8b,
    recurrentgemma_2b,
    rwkv6_1_6b,
)

# the ten archs the reference trains and serves (its ``configs.ASSIGNED``)
ASSIGNED = (
    "deepseek-67b",
    "rwkv6-1.6b",
    "minicpm-2b",
    "musicgen-large",
    "grok-1-314b",
    "mistral-nemo-12b",
    "arctic-480b",
    "llava-next-mistral-7b",
    "recurrentgemma-2b",
    "qwen3-8b",
)

__all__ = ["ASSIGNED", "ModelConfig", "get_config", "register"]
