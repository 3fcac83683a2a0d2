"""Language models of the port: the hybrid (RecurrentGemma), dense (Qwen3,
MiniCPM, Mistral-NeMo, DeepSeek, the paper's char-LM), moe (Grok-1,
Arctic), ssm (RWKV6), audio (MusicGen) and vlm (LLaVA-NeXT) families; the
stub frontends' prefixes come from ``models.multimodal``."""
from repro_torch.models.convert import (lm_flat_params_from_numpy,
                                        lm_params_from_numpy)
from repro_torch.models.multimodal import (anyres_tile_count, make_stub_prefix,
                                           prefix_shape)
from repro_torch.models.transformer import (LM, decode_step, flat_params,
                                           forward, init_decode_state,
                                           init_model, lm_loss, param_count,
                                           prefill)

__all__ = ["LM", "anyres_tile_count", "decode_step", "flat_params", "forward",
           "init_decode_state", "init_model", "lm_flat_params_from_numpy",
           "lm_loss", "lm_params_from_numpy", "make_stub_prefix", "param_count",
           "prefill", "prefix_shape"]
