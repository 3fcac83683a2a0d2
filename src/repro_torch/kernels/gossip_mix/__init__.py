from repro_torch.kernels.gossip_mix.ops import (masked_gossip_cuda,
                                               masked_gossip_mix,
                                               masked_gossip_plain,
                                               masked_gossip_update)
from repro_torch.kernels.gossip_mix.ref import masked_gossip_ref

__all__ = ["masked_gossip_cuda", "masked_gossip_mix", "masked_gossip_plain",
           "masked_gossip_update", "masked_gossip_ref"]
