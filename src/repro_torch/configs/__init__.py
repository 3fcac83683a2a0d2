"""Architecture registry of the port.  Importing this package registers the
archs whose families the port runs: hybrid (recurrentgemma-2b), dense
(qwen3-8b, minicpm-2b, mistral-nemo-12b, deepseek-67b, paper-char-lm) and
moe (grok-1-314b, arctic-480b)."""
from repro_torch.configs.base import ModelConfig, get_config, register
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    deepseek_67b,
    grok_1_314b,
    minicpm_2b,
    mistral_nemo_12b,
    paper_models,
    qwen3_8b,
    recurrentgemma_2b,
)

__all__ = ["ModelConfig", "get_config", "register"]
