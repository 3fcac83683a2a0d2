from repro_torch.kernels.sparse_gossip.ops import (scatter_active_rows,
                                                  scatter_rows_cuda,
                                                  scatter_rows_plain,
                                                  sparse_gossip_compact,
                                                  sparse_gossip_cuda,
                                                  sparse_gossip_plain,
                                                  sparse_gossip_rows)
from repro_torch.kernels.sparse_gossip.ref import (sparse_gossip_apply_ref,
                                                  sparse_gossip_ref,
                                                  sparse_scatter_rows_ref)

__all__ = ["scatter_active_rows", "scatter_rows_cuda", "scatter_rows_plain",
           "sparse_gossip_compact",
           "sparse_gossip_cuda", "sparse_gossip_plain", "sparse_gossip_rows",
           "sparse_gossip_apply_ref", "sparse_gossip_ref",
           "sparse_scatter_rows_ref"]
