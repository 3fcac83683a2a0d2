from repro_torch.kernels.gossip_mix.ops import (gossip_mix,
                                               gossip_mix_batched,
                                               gossip_mix_batched_cuda,
                                               gossip_mix_batched_plain,
                                               gossip_mix_cuda,
                                               gossip_mix_plain,
                                               masked_gossip_cuda,
                                               masked_gossip_mix,
                                               masked_gossip_plain,
                                               masked_gossip_update)
from repro_torch.kernels.gossip_mix.ref import (gossip_mix_batched_ref,
                                               gossip_mix_ref,
                                               masked_gossip_ref)

__all__ = ["gossip_mix", "gossip_mix_batched", "gossip_mix_batched_cuda",
           "gossip_mix_batched_plain", "gossip_mix_cuda", "gossip_mix_plain",
           "masked_gossip_cuda", "masked_gossip_mix", "masked_gossip_plain",
           "masked_gossip_update", "gossip_mix_batched_ref", "gossip_mix_ref",
           "masked_gossip_ref"]
