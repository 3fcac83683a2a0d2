"""Language models of the port: the hybrid (RecurrentGemma) and dense
(Qwen3, MiniCPM, Mistral-NeMo, DeepSeek, the paper's char-LM) families."""
from repro_torch.models.convert import (lm_flat_params_from_numpy,
                                        lm_params_from_numpy)
from repro_torch.models.transformer import (LM, decode_step, flat_params,
                                           forward, init_decode_state,
                                           init_model, lm_loss, param_count,
                                           prefill)

__all__ = ["LM", "decode_step", "flat_params", "forward", "init_decode_state",
           "init_model", "lm_flat_params_from_numpy", "lm_loss",
           "lm_params_from_numpy", "param_count", "prefill"]
