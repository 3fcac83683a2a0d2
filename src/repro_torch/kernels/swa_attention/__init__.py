from repro_torch.kernels.swa_attention.ops import (
    TRAIN_HEAD_DIMS, swa_attention, swa_attention_cuda, swa_attention_plain,
    swa_attention_train, swa_attention_train_bwd_cuda,
    swa_attention_train_bwd_plain, swa_attention_train_fwd_cuda,
    swa_attention_train_plain)
from repro_torch.kernels.swa_attention.ref import swa_attention_ref

__all__ = ["TRAIN_HEAD_DIMS", "swa_attention", "swa_attention_cuda",
           "swa_attention_plain", "swa_attention_ref", "swa_attention_train",
           "swa_attention_train_bwd_cuda", "swa_attention_train_bwd_plain",
           "swa_attention_train_fwd_cuda", "swa_attention_train_plain"]
