from repro_torch.utils.tree import Params, tree_size, tree_stack

__all__ = ["Params", "tree_size", "tree_stack"]
