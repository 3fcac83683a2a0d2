"""Language models of the port: the hybrid (RecurrentGemma) family."""
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.transformer import (LM, decode_step, forward,
                                           init_decode_state, init_model,
                                           prefill)

__all__ = ["LM", "decode_step", "forward", "init_decode_state", "init_model",
           "lm_params_from_numpy", "prefill"]
