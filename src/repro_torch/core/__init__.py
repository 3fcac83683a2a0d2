"""Simulator core: host-side event generation and the device-side updates;
the sharded production gossip (``ring_gossip``, ``graph_gossip`` and their
tree forms) runs over a ``torch.distributed`` process group."""
from repro_torch.core.aau import (
    graph_gossip,
    ring_gossip,
    tree_graph_gossip,
    tree_ring_gossip,
)

__all__ = ["graph_gossip", "ring_gossip", "tree_graph_gossip",
           "tree_ring_gossip"]
